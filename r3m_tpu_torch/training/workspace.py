"""The training workspace: data, model, logging and snapshots wired into one loop; the port
of ``r3m_tpu/training/workspace.py``.

The counterpart of the reference's `Workspace` and Hydra `main`
(``r3m/train_representation.py:33-150``): it seeds everything, builds the train and val
input pipelines (val: alpha 0, no augmentation, :51-52), builds the model from the
config's ``agent`` node, runs the `Until(train_steps)` loop with an `Every(eval_freq)`
eval and snapshot, and resumes from ``snapshot.npz`` on its own.

On the card, batches leave the host pipeline through a producer thread that pins them
and copies them to the device on a side stream (`Workspace._place`), at most
``device_prefetch`` batches ahead; the step's stream waits on the copy's event. The step
runs the stem pool through kernels K1/K2 (ResNet) or the attention through K3/K4 (ViT).

Over several cards the workspace is one rank of a data-parallel job, one process a card
(``torchrun``, or ``n_devices=N``, for which ``python -m r3m_tpu_torch.train_representation``
starts the ranks), as the JAX workspace is one host of a mesh (``workspace.py:144-235``):
``batch_size`` is global, and rank ``r`` of ``W`` samples its manifest shard with seed
``seed + r`` and feeds ``batch_size / W`` rows to the data-parallel step; rank 0's state
and frozen BERT are broadcast after the resume; only rank 0 logs and snapshots; a SIGTERM
stops every rank at the same step (the flag is all-reduced at each metric flush).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from r3m_tpu_torch.checkpoint import (
    AsyncSnapshotWriter,
    import_torch_snapshot_to_state,
    load_train_snapshot,
    save_train_snapshot,
    step_snapshots,
)
from r3m_tpu_torch.data.decoder import NativeFramePipeline, decoder_status
from r3m_tpu_torch.data.ego4d import Ego4DDataset, FrameBatcher
from r3m_tpu_torch.data.pipeline import DataPipeline, ProducerQueue
from r3m_tpu_torch.models.distilbert import load_bert
from r3m_tpu_torch.models.r3m import R3MConfig, resolve_device
from r3m_tpu_torch.parallel.collectives import any_rank, broadcast_state
from r3m_tpu_torch.parallel.mesh import init_distributed, local_rows, rank, world
from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer
from r3m_tpu_torch.training.trainer import (
    broadcast_train_state,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from r3m_tpu_torch.utils.config import Config, agent_to_r3m_config
from r3m_tpu_torch.utils.logger import Logger
from r3m_tpu_torch.utils.misc import Every, Until, set_seed_everywhere
from r3m_tpu_torch.utils.profiling import WORKSPACE_INPUT_WAIT, span, start_trace, stop_trace


def data_parallel_world(cfg: Config, device: torch.device) -> int:
    """The number of ranks the config asks for: ``n_devices``, or with ``n_devices: null``
    every visible card (as the JAX workspace's ``len(jax.devices())``; one on the CPU)."""
    n_dev = cfg.get("n_devices")
    if n_dev is None:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(n_dev)


def _check_world(cfg: Config, device: torch.device) -> int:
    """The job's world size: the process group's, which ``n_devices`` must agree with; with
    no group one device, and then ``n_devices`` must ask for no more."""
    want = data_parallel_world(cfg, device)
    if dist.is_initialized():
        if cfg.get("n_devices") is not None and want != world():
            raise ValueError(f"n_devices={want} but the job has {world()} ranks")
        return world()
    if want > 1:
        raise ValueError(
            f"n_devices={cfg.get('n_devices')} ({want} devices) needs one process a "
            "device: launch with torchrun, or through python -m "
            "r3m_tpu_torch.train_representation, which starts the ranks itself")
    return 1


def _report_ignored(cfg: Config, mcfg: R3MConfig) -> None:
    """Print, once, the keys the config may carry that have no meaning in this package."""
    notes = []
    if cfg.get("compilation_cache_dir"):
        notes.append("compilation_cache_dir (there is no XLA compilation cache)")
    if int(cfg.get("n_slices", 1) or 1) > 1:
        notes.append(f"n_slices={cfg.get('n_slices')} (NCCL arranges the reductions over "
                     "hosts itself)")
    agent = cfg.get("agent") or {}
    if "packed_bn" in agent:
        notes.append("agent.packed_bn (a TPU memory layout with the same math; BatchNorm "
                     "trains unpacked)")
    if "vit_fused_attn" in agent and mcfg.size == 0:
        notes.append("agent.vit_fused_attn (the ViT's attention always runs kernels K3/K4)")
    if notes:
        print("[workspace] accepted, with no effect here: " + "; ".join(notes))


class Workspace:
    """One training run: ``Workspace(cfg).train()``, then `close`.

    `cfg` is a `load_config` result of ``cfgs/config_rep.yaml``; `work_dir` (default
    ``cfg.log_dir``, else the current directory) receives ``train.csv``, ``eval.csv`` and
    the snapshots; `device` is ``"cuda"`` unless given (``cuda:LOCAL_RANK`` in a job of
    several ranks). ``distributed_init`` joins the job's process group first
    (`init_distributed`) where the caller has not.
    """

    def __init__(self, cfg: Config, work_dir: Optional[str] = None, device=None):
        self.work_dir = work_dir or cfg.get("log_dir") or os.getcwd()
        print(f"workspace: {self.work_dir}")
        self.cfg = cfg
        self.device = resolve_device(
            init_distributed(cfg.get("distributed_init", "auto"), device=device))
        self.world = _check_world(cfg, self.device)
        self.rank = rank()
        self.is_lead = self.rank == 0
        self._mesh = True if dist.is_initialized() else None
        where = (f"{self.device} ({torch.cuda.get_device_name(self.device)}); "
                 f"{torch.cuda.device_count()} CUDA device(s) visible"
                 if self.device.type == "cuda" else f"{self.device}")
        print(f"[workspace] training on {where}; rank {self.rank} of {self.world}")
        seed = set_seed_everywhere(int(cfg.get("seed", 1)))
        self.logger = Logger(
            self.work_dir,
            use_tb=bool(cfg.get("use_tb", False)) and self.is_lead,
            use_wandb=bool(cfg.get("use_wandb", False)) and self.is_lead,
            cfg=dict(cfg),
            enabled=self.is_lead,
        )

        # ---- model config ---------------------------------------------------------
        mcfg = agent_to_r3m_config(cfg["agent"])
        if cfg.get("compute_dtype"):
            mcfg = dataclasses.replace(mcfg, compute_dtype=cfg["compute_dtype"])
        _report_ignored(cfg, mcfg)

        # ---- language stack -------------------------------------------------------
        self.bert = None
        self.tokenizer = None
        if mcfg.langweight > 0:
            if not cfg.get("bert_weights"):
                raise ValueError("agent.langweight > 0 requires cfg.bert_weights")
            self.bert = load_bert(cfg["bert_weights"], self.device)
            if self.bert.cfg.dim != mcfg.lang_dim:
                # a DistilBERT of another width: the reward head takes its embedding
                mcfg = dataclasses.replace(mcfg, lang_dim=self.bert.cfg.dim)
            if not cfg.get("vocab_path"):
                raise ValueError(
                    "agent.langweight > 0 requires cfg.vocab_path (the WordPiece vocab "
                    "companion of bert_weights; both are written by `python -m "
                    "r3m_tpu_torch.prepare_language`)"
                )
            self.tokenizer = WordPieceTokenizer(vocab_file=cfg["vocab_path"])
        self.model_cfg: R3MConfig = mcfg

        # ---- data -------------------------------------------------------------------
        if cfg.get("dataset", "ego4d") != "ego4d":
            raise NameError("Invalid Dataset")
        global_bs = int(cfg.get("batch_size", 32))
        if global_bs % self.world:
            raise ValueError(f"batch_size={global_bs} not divisible by {self.world} ranks")
        bs = global_bs // self.world  # this rank's rows
        grad_accum = int(cfg.get("grad_accum", 1) or 1)
        local_rows(global_bs, grad_accum, self.world, self.rank)  # checks the layout
        print("Creating Dataloader")
        shard = dict(shard_index=self.rank, num_shards=self.world)
        train_ds = Ego4DDataset(cfg["datapath"], alpha=float(cfg.get("alpha", 0.2)),
                                seed=seed + self.rank, **shard)
        val_ds = Ego4DDataset(cfg["datapath"], alpha=0.0, seed=seed + 1 + self.rank, **shard)
        self.decoder, why = decoder_status()
        print(f"[data] JPEG decoder: {self.decoder}" + (f" ({why})" if why else ""))
        self._local_bs = bs

        # ---- steps and state -------------------------------------------------------
        doaug = str(cfg.get("doaug", "none"))
        if doaug in ("0", "False", "None"):
            doaug = "none"
        print("Initializing Model")
        self.train_step = make_train_step(
            mcfg, self.bert, doaug=doaug, grad_accum=grad_accum, device=self.device,
            mesh=self._mesh,
        )
        self.eval_step = make_eval_step(mcfg, self.bert, device=self.device, mesh=self._mesh)
        self._new_state = lambda: create_train_state(mcfg, seed, device=self.device)
        self.state = self._new_state()

        # ---- resume -----------------------------------------------------------------
        resume_meta: Dict = {}
        if cfg.get("load_snap"):
            print("LOADING", cfg["load_snap"])
            if str(cfg["load_snap"]).endswith(".pt"):
                self.state = import_torch_snapshot_to_state(cfg["load_snap"], self.state)
            else:
                self.state, resume_meta = load_train_snapshot(
                    cfg["load_snap"], self.state, with_meta=True)
        else:
            self.state, resume_meta = self._auto_resume(self.state)
        if self._mesh:  # every rank resumed; rank 0's state and frozen BERT are the job's
            broadcast_train_state(self.state)
            if self.bert is not None:
                broadcast_state(self.bert)

        # ---- data stream resume, then the pipelines ---------------------------------
        # The pipelines start drawing from the dataset generators at once, so they are
        # built only after a resumed run has fast-forwarded those generators to where the
        # interrupted run's stream stood: the resumed run then draws the batches an
        # uninterrupted run would have. The counters transfer only with the same stream
        # fingerprint, host count and batch; otherwise the stream restarts from the seed,
        # and the reason is printed.
        loaded_step = self.state.step
        self._step0 = loaded_step
        self._train_stream_pos0 = 0  # batches already drawn from train_ds's generator
        self._val_batches = 0  # batches drawn from val_ds's
        ds_meta = (resume_meta or {}).get("data_stream") or {}
        self._stream_fp = {"train": train_ds.stream_fingerprint(),
                           "val": val_ds.stream_fingerprint()}
        if loaded_step > 0 and bool(cfg.get("resume_data_stream", True)):
            if (ds_meta.get("local_batch_size") == bs
                    and ds_meta.get("num_hosts") == self.world
                    and ds_meta.get("stream_fp") == self._stream_fp):
                t_n = int(ds_meta.get("train_batches", 0))
                v_n = int(ds_meta.get("val_batches", 0))
                train_ds.skip_batches(t_n, bs)
                val_ds.skip_batches(v_n, bs)
                self._train_stream_pos0 = t_n
                self._val_batches = v_n
                print(f"[resume] data stream fast-forwarded: train {t_n} / val {v_n} "
                      "batches (the uninterrupted run's stream)")
            elif ds_meta:
                if ds_meta.get("stream_fp") not in (None, self._stream_fp):
                    why = ("another stream fingerprint (another dataset, alpha or seed, "
                           "or a JAX package snapshot, whose fingerprint hashes paths)")
                elif "stream_fp" in ds_meta:
                    why = (f"{ds_meta.get('num_hosts')} hosts x batch "
                           f"{ds_meta.get('local_batch_size')} (this run: {self.world} x "
                           f"{bs})")
                else:
                    why = "a snapshot without a stream fingerprint"
                print(f"[resume] the snapshot's data-stream counters were taken against "
                      f"{why}; the stream restarts from the seed")
            else:
                print("[resume] the snapshot has no data-stream counters; the stream "
                      "restarts from the seed")
        lml = int(cfg.get("lang_max_len", 32))
        self.train_pipe = DataPipeline(self._make_batcher(train_ds), tokenizer=self.tokenizer,
                                       lang_max_len=lml)
        self.val_pipe = DataPipeline(self._make_batcher(val_ds), tokenizer=self.tokenizer,
                                     lang_max_len=lml)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        # snapshot writes overlap training (the device -> host copy stays synchronous);
        # async_snapshot=false makes every save blocking
        self._snap_writer = (AsyncSnapshotWriter() if self.is_lead
                             and bool(cfg.get("async_snapshot", True)) else None)
        self._stop_requested = False  # set by a signal
        self._stop = False  # in a job: whether any rank's was set, at the last flush

    # ------------------------------------------------------------------------------
    def _make_batcher(self, ds: Ego4DDataset):
        cfg = self.cfg
        n_threads = int(cfg.get("num_workers", 8))
        if bool(cfg.get("native_pipeline", True)):
            try:
                return NativeFramePipeline(ds, self._local_bs, n_threads=n_threads)
            except RuntimeError as e:  # no native library: the Python batcher
                print(f"[data] {e}; batches come from FrameBatcher")
        return FrameBatcher(ds, self._local_bs, n_threads=n_threads)

    def _auto_resume(self, state):
        """Resume from the rolling snapshot; where it is corrupt or truncated, from the
        newest per-step snapshot that loads. Returns ``(state, meta)``, meta {} on a
        fresh start."""
        candidates = []
        rolling = os.path.join(self.work_dir, "snapshot.npz")
        if os.path.exists(rolling):
            candidates.append(rolling)
        candidates.extend(p for _, p in step_snapshots(self.work_dir))
        for path in candidates:
            try:
                print(f"resuming: {path}")
                return load_train_snapshot(path, state, with_meta=True)
            except Exception as e:  # any unreadable file: try the next candidate
                print(f"[resume] {path} unusable ({type(e).__name__}: {e})")
                state = self._new_state()  # the failed load may have filled part of it
        return state, {}

    def request_stop(self) -> None:
        """Ask the loop to stop after the current step (safe in a signal handler: it sets
        a flag). The CLI wires SIGTERM here, so an evicted job finishes its step, writes a
        final snapshot and exits cleanly for auto-resume."""
        self._stop_requested = True

    def _agree_stop(self) -> None:
        """In a job of several ranks, at a metric flush (every rank reaches it at the same
        step): stop when any rank was asked to (one all-reduce), so that every rank stops
        after the same step."""
        if self._mesh:
            self._stop = any_rank(self._stop_requested, self.device)

    def _stopping(self) -> bool:
        """Whether to stop: on one device as soon as asked; in a job, as last agreed."""
        return self._stop if self._mesh else self._stop_requested

    @property
    def global_step(self) -> int:
        return self.state.step

    def _place(self, batch: Dict):
        """A host batch on the device: ``(tensors, event)``, the captions dropped.

        On the card each array is pinned (`pin_memory`) and copied with
        ``non_blocking=True`` on the side stream, where an event is recorded; `_ready`
        makes the step's stream wait for it. On the CPU the event is None.
        """
        tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
                   if k != "captions"}
        if self._copy_stream is None:
            return {k: t.to(self.device) for k, t in tensors.items()}, None
        torch.cuda.set_device(self.device)  # the producer thread's device
        pinned = {k: t.pin_memory() for k, t in tensors.items()}
        with torch.cuda.stream(self._copy_stream):
            placed = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return placed, event

    def _ready(self, item) -> Dict[str, torch.Tensor]:
        """The tensors of a `_place` result, usable on the current stream: it waits for
        the copy's event, and each tensor is recorded on it, so that its memory (allocated
        on the side stream) is not handed to a later copy while a step still reads it."""
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors

    def _device_prefetch(self, pipe, depth: int = 2):
        """Generator of placed batches (`_place` results), up to `depth` ahead.

        A producer thread places them, reserving a queue slot before it places one, so at
        most `depth` placed batches wait besides the one in use; ``depth <= 0`` places in
        the caller's thread, with no producer.
        """
        if depth <= 0:
            for batch in pipe:
                yield self._place(batch)
            return
        pq = ProducerQueue(pipe, maxsize=depth, transform=self._place, reserve_first=True,
                           name="device prefetch")
        try:
            yield from pq
        finally:
            pq.close()

    def train(self) -> None:
        cfg = self.cfg
        until = Until(cfg.get("train_steps", 2_000_000))
        every = Every(cfg.get("eval_freq", 20_000))
        print("Begin Training")
        # Per-step metrics stay 0-d device tensors and are read in one stacked copy every
        # `metric_flush` steps, after later steps have been queued: no per-step sync.
        flush_n = int(cfg.get("metric_flush", 10))
        placed = self._device_prefetch(self.train_pipe, depth=int(cfg.get("device_prefetch", 2)))
        try:
            self._train_loop(placed, until, every, flush_n)
        finally:
            placed.close()  # stops the producer and frees its device batches
        if (self._stopping() and self.is_lead and cfg.get("snapshot", True)
                and self.global_step > 0):
            print(f"[workspace] stop requested — snapshot at step {self.global_step}")
            self.save_snapshot()
        self.flush_snapshots()  # every snapshot durable before returning

    def _train_loop(self, placed, until, every, flush_n) -> None:
        cfg = self.cfg
        prof_dir = cfg.get("profile_dir") or ""
        # trace steps [resume + 10, + profile_steps): relative, so a resumed run traces too
        prof_start = self.global_step + 10
        prof_n = int(cfg.get("profile_steps", 5))
        prof = None
        pending = []  # [(step, device metrics, sample_s, update_s)]
        win_t0 = time.time()  # window wall clock -> the true time a step
        while until(self.global_step) and not self._stopping():
            if prof_dir and prof is None and self.global_step == prof_start:
                prof = start_trace(prof_dir)
            t0 = time.time()
            with span(WORKSPACE_INPUT_WAIT):
                batch = self._ready(next(placed))
            t1 = time.time()
            self.state, metrics = self.train_step(self.state, batch)
            t2 = time.time()
            step = self.global_step
            pending.append((step, metrics, t1 - t0, t2 - t1))
            if prof is not None and step >= prof_start + prof_n:
                stop_trace(prof)
                prof, prof_dir = None, ""  # one trace a run
                print(f"profile trace written: {cfg.get('profile_dir')}")
            if len(pending) >= flush_n:
                self._flush_train_metrics(pending, win_t0)
                pending = []
                self._agree_stop()
                win_t0 = time.time()

            if every(step - 1):
                self._flush_train_metrics(pending, win_t0)
                pending = []
                self._agree_stop()
                self._evaluate(step)
                if cfg.get("snapshot", True) and self.is_lead:
                    self.save_snapshot()
                win_t0 = time.time()  # eval and snapshot are not billed to the steps
        if prof is not None:
            # training ended inside the window: close the trace, so that it is written
            # and the profiler is free for a later run
            stop_trace(prof)
            print(f"profile trace written: {cfg.get('profile_dir')}")
        self._flush_train_metrics(pending, win_t0)
        self.logger.dump(self.global_step)

    def _evaluate(self, step: int) -> None:
        """``eval_batches`` val batches, their metrics averaged (the reference scores one
        a call, train_representation.py:114-117). The permutations come from a generator
        seeded with `step` alone, so a resumed run evaluates as an uninterrupted one."""
        n_eval = max(1, int(self.cfg.get("eval_batches", 1) or 1))
        generator = torch.Generator(device=self.device).manual_seed(step)
        acc: Dict[str, float] = {}
        for _ in range(n_eval):
            batch = self._ready(self._place(next(self.val_pipe)))
            self._val_batches += 1
            em = self.eval_step(self.state, batch, generator)
            values = torch.stack([v.detach().float() for v in em.values()]).cpu().tolist()
            for k, v in zip(em, values):
                acc[k] = acc.get(k, 0.0) + v
        emetrics = {k: v / n_eval for k, v in acc.items()}
        self.logger.log_metrics(emetrics, step, ty="eval")
        self.logger.dump(step, ty="eval")
        if self.is_lead:
            print("EVAL", step, emetrics)

    def _flush_train_metrics(self, pending, win_t0=None) -> None:
        """One stacked device -> host copy for a window of per-step metric dicts.

        Steps run asynchronously: ``sample_time`` is the host's wait for the input and
        ``update_time`` only the time to queue the step; the device work lands at the
        copy here. ``step_time`` is the honest figure: the window's wall clock (the copy
        included) a step. The reference's synchronous prints (train_representation.py:110)
        correspond to step_time.
        """
        if not pending:
            return
        flat = [(i, k) for i, (_, m, _, _) in enumerate(pending) for k in m]
        values = torch.stack([pending[i][1][k].detach().float().reshape(())
                              for i, k in flat]).cpu().tolist()
        fetched = [dict() for _ in pending]
        for (i, k), v in zip(flat, values):
            fetched[i][k] = v
        step_s = (time.time() - win_t0) / len(pending) if win_t0 else None
        for (step, _, sample_s, update_s), metrics in zip(pending, fetched):
            metrics["sample_time"] = sample_s
            metrics["update_time"] = update_s
            if step_s is not None:
                metrics["step_time"] = step_s
            self.logger.log_metrics(metrics, step, ty="train")
            if step % 10 == 0 and self.is_lead:
                print(step, metrics)
                print(f"Sample time {sample_s}, Update time {update_s}"
                      + (f", Step time {step_s:.4f}" if step_s is not None else ""))
                self.logger.dump(step, ty="train")

    def save_snapshot(self) -> str:
        """Snapshot the current state as ``snapshot_{step}.npz`` and the rolling
        ``snapshot.npz``; returns the rolling path.

        The device -> host copy happens here, before the next step can change the state
        in place. With ``async_snapshot`` (the default) the file is written in the
        background: call `flush_snapshots` (`train` and `close` do) before reading it.
        """
        extra = {
            "lang_max_len": int(self.cfg.get("lang_max_len", 32)),
            # the data-stream positions as the loop consumed them (the prefetch queues
            # run ahead; a resume replays only what the loop used)
            "data_stream": {
                "train_batches": self._train_stream_pos0 + (self.global_step - self._step0),
                "val_batches": self._val_batches,
                "local_batch_size": self._local_bs,
                "num_hosts": self.world,
                "stream_fp": self._stream_fp,
            },
        }
        if self._snap_writer is not None:
            self._snap_writer.wait()  # the previous write is durable: prune after it
        self._prune_snapshots()
        path = save_train_snapshot(self.work_dir, self.state, self.model_cfg,
                                   extra_meta=extra, writer=self._snap_writer)
        if self._snap_writer is None:
            self._prune_snapshots()
        return path

    def _prune_snapshots(self) -> None:
        """Keep the newest ``keep_snapshots`` per-step snapshots (0 keeps all); the
        rolling one stays. The reference keeps every one (~1 GB each)."""
        keep = int(self.cfg.get("keep_snapshots", 0))
        if keep <= 0:
            return
        for _, p in step_snapshots(self.work_dir)[keep:]:
            try:
                os.remove(p)
            except OSError:
                pass

    def flush_snapshots(self) -> None:
        """Block until the snapshot write in flight, if any, is durable."""
        if self._snap_writer is not None:
            self._snap_writer.wait()
            self._prune_snapshots()

    def close(self) -> None:
        # must not raise: it runs in finally blocks (the --retries loop), where an
        # exception would hide the original error and skip the pipelines' shutdown
        try:
            self.flush_snapshots()
        except Exception as e:  # a failed background write, reported
            print(f"[workspace] async snapshot write failed: {e!r}")
        self.train_pipe.close()
        self.val_pipe.close()
