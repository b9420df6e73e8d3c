"""Mean device time of the optimizer in a train step: the global norm,
the clip and AdamW's update (the ``train.optimizer`` span that the port's
train step records), over the window's steps that neither the harness
traced nor a profiler recorded, chosen as ``lm_head_ms.train`` chooses
them, ms. None where the step records no such span."""
from pathlib import Path

from portbench.harness.spec import load_module

_head = load_module(Path(__file__).with_name("lm_head_ms.train.py"),
                    "portbench_metric_lm_head_ms_train")


def read(run):
    return _head.phase_ms(run, ("optimizer",))
