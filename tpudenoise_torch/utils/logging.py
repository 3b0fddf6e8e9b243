"""Metrics sinks (counterpart of `tpudenoise/utils/logging.py`).

One logger facade: stdout and JSONL always; TensorBoard event files
through `torch.utils.tensorboard` when a tb_dir is given and that module
imports (it needs the `tensorboard` package, which the GPU machine may
lack); wandb when a project is given and wandb imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None,
                 project: Optional[str] = None, quiet: bool = False,
                 tb_dir: Optional[str] = None):
        self.logdir = logdir
        self.quiet = quiet
        self._jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, 'metrics.jsonl'), 'a')
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tb_dir)
            except Exception:
                self._tb = None
        self._wandb = None
        if project:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project)
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = dict(metrics)
        rec['_time'] = time.time()
        if step is not None:
            rec['_step'] = int(step)
        if not self.quiet:
            parts = ' '.join(f'{k}={v:.6g}' if isinstance(v, float)
                             else f'{k}={v}' for k, v in metrics.items())
            print((f'[step {step}] ' if step is not None else '') + parts)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + '\n')
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def log_histogram(self, tag: str, values, step: Optional[int] = None):
        """Histogram summary to TensorBoard and wandb, when attached."""
        import numpy as np
        values = np.asarray(values, np.float32).ravel()
        if values.size == 0:
            return
        if self._tb:
            self._tb.add_histogram(tag, values, global_step=step)
        if self._wandb:
            self._wandb.log({tag: self._wandb.Histogram(values)},
                            step=step)

    def log_scalar_quiet(self, tag: str, value: float,
                         step: Optional[int] = None):
        """Scalar straight to TensorBoard/wandb, not stdout or JSONL: the
        high-rate per-detection records.  The step goes to TensorBoard
        only, since wandb drops steps that go backwards."""
        if self._tb:
            self._tb.add_scalar(tag, float(value), global_step=step)
        if self._wandb:
            self._wandb.log({tag: float(value)})

    def flush(self):
        if self._tb:
            self._tb.flush()

    @property
    def active_sinks(self) -> bool:
        """True when a TensorBoard or wandb sink is attached (callers skip
        summary work otherwise)."""
        return self._tb is not None or self._wandb is not None

    def log_image(self, tag: str, image, step: Optional[int] = None):
        """Image summary, (H, W, 3) uint8 RGB, to TensorBoard and wandb."""
        import numpy as np
        image = np.ascontiguousarray(image)
        if self._tb:
            self._tb.add_image(tag, image, global_step=step,
                               dataformats='HWC')
            self._tb.flush()
        if self._wandb:
            self._wandb.log({tag: self._wandb.Image(image)}, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


_GLOBAL: Optional[MetricsLogger] = None


def get_metrics_logger() -> MetricsLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsLogger()
    return _GLOBAL


def set_metrics_logger(logger: MetricsLogger):
    global _GLOBAL
    _GLOBAL = logger
