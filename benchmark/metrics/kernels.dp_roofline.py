"""kernels.dp_roofline: the least time the card could take for the
fused DP's work over the window's streamed reads (``roofline.dp_work``,
counted from the reference's own model of each job), as a share of the
device time of every kernel inside the jobs in the traced run.

The device time counts every kernel but copies, sets and the ``-arch``
detection's scoring kernel (K4, the backward kernel's instance without the
stack); ``LEFT_OUT`` lists their names.  Nothing where the work is not
known (a job calibrates, or failed) or the trace holds no kernel."""

import re

from benchmark import roofline

LEFT_OUT = re.compile(r"Memcpy|Memset|memcpy|memset|bwd_dense<false|bwd_kernel<false")


def read(run):
    t, work = run["trace"], run["work"]
    if not t or not work:
        return None
    kernel_s = 0.0
    for name, a, b in t["device"]:
        if LEFT_OUT.search(name):
            continue
        for ja, jb in t["jobs"]:
            lo, hi = max(a, ja), min(b, jb)
            if hi > lo:
                kernel_s += hi - lo
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(work) / kernel_s
