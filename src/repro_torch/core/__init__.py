"""Core of the port: query compilation and the streaming match engine.

Import the submodules directly (``repro_torch.core.engine`` etc.); this
package file imports nothing, so the host-side modules load without
torch's device code.
"""
