"""The optimiser and its schedules (the port of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_with_warmup
