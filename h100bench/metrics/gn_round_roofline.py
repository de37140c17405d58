"""Share of its roofline that gn_round (one association round and its
inner Gauss-Newton steps per launch) reaches: the least time for the bytes
and operations of every round of the traced stretch (roofline.gn_round_work
from each launch's batch, points, valid samples and inner steps) over its
traced device time. One reader for every cell group
(``gn_round_roofline.<group>``)."""

from h100bench import readers, roofline

KERNELS = ("gn_round_kernel",)
# (B, P, the (B, P) validity of the samples, the configuration's inner steps)
RECORDS = {"gn_round": ("realsensetracker_tpu_torch.kernels.gn_step", "gn_round",
                        lambda a, k, out: (a[1].shape[0], a[1].shape[-1], a[2], a[5].inner_iters))}


def read(run):
    work = readers.summed(roofline.gn_round_work(b, p, int(ok.sum()), max(int(inner), 1))
                          for b, p, ok, inner in run.logs.get("gn_round", []))
    return readers.roofline_pct(run, KERNELS, work)
