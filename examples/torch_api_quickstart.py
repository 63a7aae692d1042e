"""Public-API quickstart of the PyTorch/CUDA port: the full lifecycle.

The twin of ``examples/api_quickstart.py`` on ``repro_torch``: declare a
timing-constrained pattern with the DSL, register it in a StreamSession
(with cross-tenant prefix sharing on), ingest typed events, read typed
matches and metrics, crash, restore, and keep serving without missing
anything still inside the window.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_api_quickstart.py
    PYTHONPATH=src python examples/torch_api_quickstart.py --device cpu
"""

import argparse
import tempfile

from repro_torch.api import Event, Pattern, StreamSession


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # Lateral movement: a login that is strictly followed by a transfer
    # through the compromised host, both within a 300-tick window.
    pattern = (Pattern("lateral-movement")
               .edge("attacker", "host", label="login")
               .edge("host", "server", label="xfer")
               .before(0, 1)            # login strictly precedes xfer
               .window(300))

    ckpt_dir = tempfile.mkdtemp(prefix="tcss_torch_quickstart_")
    sess = StreamSession(ckpt_dir=ckpt_dir, share_prefixes=True,
                         device=args.device)
    sub = sess.register(pattern)

    # Another tenant authors the SAME structure differently: reversed
    # edge order, different names.  The canonicalizing planner maps both
    # onto one built slot tick, and the shared-prefix forest keeps ONE
    # table for their common login->xfer chain.
    other = (Pattern("exfil")
             .edge("pivot", "target", label="xfer", name="out")
             .edge("entry", "pivot", label="login", name="in")
             .before("in", "out")
             .window(300))
    sub2 = sess.register(other)
    assert sess.service.n_compiles == 1, "isomorphic patterns share a tick"
    assert sub2.shared_prefix.n_tenants == 2, "one prefix chain, two tenants"

    events = [
        Event(src=1, dst=2, ts=10, label="login"),
        Event(src=7, dst=8, ts=15, label="probe"),
        Event(src=2, dst=9, ts=40, label="xfer"),     # completes the chain
        Event(src=3, dst=4, ts=60, label="login"),
    ]
    sess.ingest(events)
    for m in sub.drain():
        print(f"match: attacker={m.bindings['attacker']} "
              f"host={m.bindings['host']} server={m.bindings['server']} "
              f"login@{m.times['e0']} xfer@{m.times['e1']}")
    assert len(sub2.drain()) == 1        # same structure, same match
    print(f"backend {sess.service.backend} on {sess.service.device}; "
          f"forest {sess.service.forest_stats()}")

    # make the session durable, then "crash"
    sess.checkpoint()
    sess.close()
    print(f"checkpoints: {sess.metrics()['ckpt.n_checkpoints']:.0f}")
    del sess, sub, sub2

    # restore: same qids, same vocab, same pattern plans — and nothing
    # still inside the window is missed on replay
    sess = StreamSession.restore(ckpt_dir, device=args.device)
    sub, sub2 = sess.subscriptions()
    print(f"restored {len(sess.subscriptions())} subscriptions at "
          f"offset {sess.resume_offset}")
    sess.ingest([Event(src=4, dst=5, ts=70, label="xfer")])  # 3->4->5 chain
    (m,) = sub.drain()
    print(f"post-restore match: {m.bindings} at ts={m.ts}")
    assert m.bindings == {"attacker": 3, "host": 4, "server": 5}
    assert len(sub.matches()) == 2       # both chains live in the window
    print(next(ln for ln in sess.prometheus().splitlines()
               if ln.startswith("repro_share_n_nodes")))
    print("quickstart OK")


if __name__ == "__main__":
    main()
