"""Tensorboard logging for ``fit()`` (counterpart of
``kubeflow_rm_tpu/utils/tensorboard.py``).

The platform's tensorboard controller serves a Tensorboard CR over a
``gs://`` or ``pvc://`` path; this callback writes those logs from inside
the notebook, the same five scalars under the same tags as the JAX
package. It writes through ``torch.utils.tensorboard`` (which needs the
``tensorboard`` package), imported when the callback is made so the
library stays optional elsewhere.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.training.loop import LoopMetrics


class TensorboardCallback:
    """``fit(callbacks=(TensorboardCallback(logdir),))``: one scalar per
    ``LoopMetrics`` field per log interval, flushed at once so a
    Tensorboard server tailing the directory sees points live."""

    def __init__(self, logdir: str, *, flush_secs: int = 10):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir, flush_secs=flush_secs)

    def __call__(self, m: LoopMetrics) -> None:
        self.writer.add_scalar("train/loss", m.loss, m.step)
        self.writer.add_scalar("train/grad_norm", m.grad_norm, m.step)
        self.writer.add_scalar("perf/tokens_per_sec", m.tokens_per_sec,
                               m.step)
        self.writer.add_scalar("perf/mfu_pct", m.mfu_pct, m.step)
        self.writer.add_scalar("perf/step_time_ms", m.step_time_ms, m.step)
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
