"""Metrics logging: CSV meters, the console, and optional wandb/TensorBoard sinks.

The port's copy of ``r3m_tpu/utils/logger.py`` (pure Python), the counterpart of the
reference's `Logger` (``r3m/utils/logger.py``): `AverageMeter` accumulation into
``train.csv`` / ``eval.csv`` with resume-aware headers and stale-row pruning
(logger.py:61-92), a formatted console dump, and a remote sink, wandb when importable
(logger.py:135-146) or TensorBoard through torch's SummaryWriter. Both remote sinks are
optional and off by default; the CSV files are always written.
"""

from __future__ import annotations

import csv
import datetime
import os
from collections import defaultdict
from typing import Dict, Optional

COMMON_TRAIN_FORMAT = [
    ("step", "S", "int"),
    ("full_loss", "LOSS", "float"),
    ("tcnloss", "TCN", "float"),
    ("rewloss", "REW", "float"),
    ("aligned", "ALIGN", "float"),
    ("total_time", "T", "time"),
]


class AverageMeter:
    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def update(self, value: float, n: int = 1):
        self._sum += value * n
        self._count += n

    def value(self) -> float:
        return self._sum / max(1, self._count)


class MetersGroup:
    def __init__(self, csv_file_name: str, formatting):
        self._csv_file_name = csv_file_name
        self._formatting = formatting
        self._meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self._csv_file = None
        self._csv_writer = None

    def log(self, key: str, value: float, n: int = 1):
        self._meters[key].update(value, n)

    def _prime_meters(self) -> Dict[str, float]:
        data = {}
        for key, meter in self._meters.items():
            # strip "train/" / "eval/" namespace for the CSV column
            data[key.split("/", 1)[-1]] = meter.value()
        self._meters.clear()
        return data

    def _remove_old_entries(self, data):
        """On resume, drop rows at/after the current step (logger.py:71-92)."""
        rows = []
        with open(self._csv_file_name) as f:
            reader = csv.DictReader(f)
            for row in reader:
                if row.get("step") and float(row["step"]) >= data["step"]:
                    break
                rows.append(row)
        with open(self._csv_file_name, "w", newline="") as f:
            # old rows may carry columns the new run lacks (e.g. resumed with
            # langweight=0 after training with 1.0) — keep only current ones
            fieldnames = sorted(data.keys())
            writer = csv.DictWriter(f, fieldnames=fieldnames, restval=0.0)
            writer.writeheader()
            for row in rows:
                writer.writerow({k: row.get(k, 0.0) for k in fieldnames})

    def _dump_to_csv(self, data):
        if self._csv_writer is None:
            should_write_header = True
            if os.path.exists(self._csv_file_name):
                self._remove_old_entries(data)
                should_write_header = False
            self._csv_file = open(self._csv_file_name, "a", newline="")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=sorted(data.keys()), restval=0.0
            )
            if should_write_header:
                self._csv_writer.writeheader()
        self._csv_writer.writerow({k: data.get(k, 0.0) for k in self._csv_writer.fieldnames})
        self._csv_file.flush()

    @staticmethod
    def _format(key, value, ty):
        if ty == "int":
            return f"{key}: {int(value)}"
        if ty == "float":
            return f"{key}: {value:.04f}"
        if ty == "time":
            return f"{key}: {datetime.timedelta(seconds=int(value))}"
        raise ValueError(f"invalid format type: {ty}")

    def _dump_to_console(self, data, prefix):
        pieces = [f"| {prefix: <5}"]
        for key, disp_key, ty in self._formatting:
            if key in data:
                pieces.append(self._format(disp_key, data[key], ty))
        print(" | ".join(pieces))

    def dump(self, step: int, prefix: str):
        if not self._meters:
            return
        data = self._prime_meters()
        data["step"] = step
        self._dump_to_csv(data)
        self._dump_to_console(data, prefix)


class Logger:
    """log_metrics(metrics, step, ty) -> CSV meters + optional remote sink."""

    def __init__(
        self,
        log_dir: str,
        use_tb: bool = False,
        use_wandb: bool = False,
        cfg: Optional[dict] = None,
        enabled: bool = True,
    ):
        """`enabled=False` makes every sink a no-op — used by non-lead hosts
        in multi-process runs so shared-filesystem CSVs aren't interleaved."""
        self._enabled = enabled
        if not enabled:
            use_tb = use_wandb = False
        self._log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._train_mg = MetersGroup(
            os.path.join(log_dir, "train.csv"), COMMON_TRAIN_FORMAT
        )
        self._eval_mg = MetersGroup(
            os.path.join(log_dir, "eval.csv"), COMMON_TRAIN_FORMAT
        )
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb

                cfg = cfg or {}
                self._wandb = wandb.init(
                    project=cfg.get("wandbproject"),
                    entity=cfg.get("wandbuser"),
                    name=cfg.get("experiment"),
                    config=cfg,
                )
            except Exception as e:  # zero-egress or wandb absent
                print(f"[logger] wandb disabled: {e}")
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception as e:
                print(f"[logger] tensorboard disabled: {e}")

    def log_metrics(self, metrics: Dict[str, float], step: int, ty: str):
        if not self._enabled:
            return
        mg = self._train_mg if ty == "train" else self._eval_mg
        for key, value in metrics.items():
            v = float(value)
            mg.log(f"{ty}/{key}", v)
            if self._wandb is not None:
                self._wandb.log({f"{ty}/{key}": v}, step=step)
            if self._tb is not None:
                self._tb.add_scalar(f"{ty}/{key}", v, step)

    def dump(self, step: int, ty: Optional[str] = None):
        if not self._enabled:
            return
        if ty is None or ty == "train":
            self._train_mg.dump(step, "train")
        if ty is None or ty == "eval":
            self._eval_mg.dump(step, "eval")

    def log_and_dump_ctx(self, step: int, ty: str) -> "LogAndDumpCtx":
        """Collect (key, value) pairs via calls, dump once on exit
        (reference `LogAndDumpCtx`, logger.py:170-183)."""
        return LogAndDumpCtx(self, step, ty)


class LogAndDumpCtx:
    def __init__(self, logger: Logger, step: int, ty: str):
        self._logger = logger
        self._step = step
        self._ty = ty

    def __enter__(self) -> "LogAndDumpCtx":
        return self

    def __call__(self, key: str, value: float):
        self._logger.log_metrics({key: value}, self._step, self._ty)

    def __exit__(self, *args):
        self._logger.dump(self._step, self._ty)
