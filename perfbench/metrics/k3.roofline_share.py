"""K3's share of its roofline: for each call of ``kernels/ops.py::
flash_attention`` in the profiled stretch, the least time its own shapes
need (half of 4·BH·T²·hd operations at the bf16 peak; q, k, v read and o
written once at HBM bandwidth), over the device time of the operations
launched inside the call, in percent."""
from perfbench.flops import flash_work, roofline_s


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.range_device_s("bench.k3")
    bound = sum(roofline_s(*flash_work(*map(int, args))) for args, _ in calls)
    dev_s = sum(s for _, s in calls)
    return 100.0 * bound / dev_s if dev_s > 0 else None
