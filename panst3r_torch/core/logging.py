"""Metric logging backends (counterpart of panst3r_tpu/core/logging.py):
the JSON-lines epoch log, TensorBoard (torch's ``SummaryWriter``), wandb
and MLflow (each imported only when selected), the smoothed meters and
``build_logger``.  The JAX package lets only process 0 write
(``jax.process_index()``); the port trains in one process, which writes.
"""
from __future__ import annotations

import json
import time
from abc import ABC, abstractmethod
from collections import deque
from pathlib import Path


class Logger(ABC):
    @abstractmethod
    def log(self, values: dict, step: float):
        ...

    def flush(self):
        pass

    def close(self):
        pass


class JsonlLogger(Logger):
    """Append JSON lines to ``log.txt``."""

    def __init__(self, output_dir: str | Path, fname: str = "log.txt"):
        self.path = Path(output_dir) / fname
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, values: dict, step: float):
        rec = {"step": step, "time": time.time(), **values}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")


class TBLogger(Logger):
    """TensorBoard scalars, the step in thousandths of an epoch."""

    def __init__(self, output_dir: str | Path):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=str(output_dir))

    def log(self, values: dict, step: float):
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), global_step=int(step * 1000))

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class WandbLogger(Logger):
    """Weights & Biases (needs the wandb package and its server)."""

    def __init__(self, output_dir, project="panst3r_torch", config=None):
        import wandb

        self.run = wandb.init(project=project, dir=str(output_dir),
                              config=config or {})

    def log(self, values: dict, step: float):
        self.run.log(values, step=int(step * 1000))

    def close(self):
        self.run.finish()


class MLFlowLogger(Logger):
    """MLflow (needs the mlflow package; ``MLFLOW_TRACKING_URI``)."""

    def __init__(self, output_dir, project="panst3r_torch", config=None):
        import mlflow

        self.mlflow = mlflow
        mlflow.set_experiment(project)
        self.run = mlflow.start_run()
        if config:
            mlflow.log_params({k: str(v)[:250] for k, v in config.items()})

    def log(self, values: dict, step: float):
        self.mlflow.log_metrics({k.replace("/", "_"): float(v)
                                 for k, v in values.items()},
                                step=int(step * 1000))

    def close(self):
        self.mlflow.end_run()


class SmoothedValue:
    """A windowed running statistic and its global average."""

    def __init__(self, window_size: int = 20):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return (sum(self.window) / len(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    """Smoothed meters by name (croco's MetricLogger)."""

    def __init__(self, window_size: int = 20):
        self.meters: dict[str, SmoothedValue] = {}
        self.window_size = window_size

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters.setdefault(
                k, SmoothedValue(self.window_size)).update(float(v))

    def global_avgs(self) -> dict:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self):
        return "  ".join(f"{k}: {m.avg:.4f}" for k, m in self.meters.items())


class LoggerList(Logger):
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log(self, values, step):
        for lg in self.loggers:
            lg.log(values, step)

    def flush(self):
        for lg in self.loggers:
            lg.flush()

    def close(self):
        for lg in self.loggers:
            lg.close()


def build_logger(kind: str, output_dir) -> Logger:
    """The JSON-lines log plus the ``kind`` backend ("tensorboard",
    "wandb", "mlflow"; any other name: none; a backend that fails to start
    is left out)."""
    loggers: list[Logger] = [JsonlLogger(output_dir)]
    backend = {"tensorboard": TBLogger, "wandb": WandbLogger,
               "mlflow": MLFlowLogger}.get(kind)
    if backend is not None:
        try:
            loggers.append(backend(output_dir))
        except Exception:
            pass
    return LoggerList(loggers)
