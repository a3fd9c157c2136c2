"""The joint step's counted FLOPs over the window's step time and the
dense bf16 peak, %."""
from benchmark.metrics._shared import mfu


def read(run):
    return mfu(run, "steps") if run["traffic"]["kind"] == "joint_train" else None
