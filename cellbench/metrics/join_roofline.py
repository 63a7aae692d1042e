"""The joins' least time over their device time, in %: the least time
of each call of ``join_pairs`` (``work.join_work``: valid masks, live
rows read once, emitted pairs written once; at the H100's peaks) summed
over the window, over the device time of the benchmark's ``join`` ranges
(``trace.py``)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.join_timed or t.join_device_s <= 0:
        return None
    return 100.0 * t.join_least_s / t.join_device_s
