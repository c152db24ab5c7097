"""Host time a train step spends in the sub-steps that train the prior
(the program's ``train.step.prior``, ``train.step.inner_sigma`` and
``train.step.z_std`` spans), summed over the traced half and divided by
its ``train.step`` spans."""

from ladder_tpu_torch.utils import profiling

SUBSTEPS = ("train.step.prior", "train.step.inner_sigma", "train.step.z_std")


def read(run):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    spans = recorded()["spans"]
    steps = sum(s.name == "train.step" for s in spans)
    if not steps:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name in SUBSTEPS) / steps
