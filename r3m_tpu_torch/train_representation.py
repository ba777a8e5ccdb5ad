"""R3M pretraining on the card: the port's counterpart of the repo's root
``train_representation.py``.

    python -m r3m_tpu_torch.train_representation datapath=/path/to/ego4d \
        agent.langweight=1.0 agent.size=50 doaug=rctraj batch_size=64 \
        bert_weights=distilbert.npz vocab_path=vocab.txt

The config is ``cfgs/config_rep.yaml`` at the repo's root (``--config PATH`` for another);
``key.path=value`` overrides are YAML-typed and strict (an unknown key raises,
``+key=value`` adds one). ``--device`` is ``cuda`` unless given (``--device cpu`` trains
on the CPU). ``--retries N`` rebuilds the workspace after a crash, up to N times, and
auto-resume continues from the last snapshot. SIGTERM finishes the current step, writes a
final snapshot and exits 0.

Over several cards, one process a card:

    torchrun --nproc_per_node=8 -m r3m_tpu_torch.train_representation datapath=... \
        batch_size=512

or ``n_devices=8`` without a launcher, for which this command starts the 8 ranks itself
(``n_devices: null`` takes every visible card). ``batch_size`` is the global batch.
``distributed_init`` (``auto``, ``true``, ``false``) says whether to join the job's process
group, as the root CLI's does; under a launcher ``n_devices``, if set, must equal the
job's world size.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "cfgs", "config_rep.yaml")


def _install_sigterm(ws) -> None:
    """SIGTERM -> `Workspace.request_stop` (train_representation.py:84-95): the current
    step finishes, a final snapshot is written, and the run exits for auto-resume."""

    def handler(signum, frame):
        print("[signal] SIGTERM — stopping after current step")
        ws.request_stop()

    signal.signal(signal.SIGTERM, handler)


def _run(cfg, device, retries: int) -> None:
    """One process's training: join the job's process group (where the config or a
    launcher asks), then the workspace, rebuilt up to `retries` times after a crash."""
    from r3m_tpu_torch.parallel.mesh import init_distributed
    from r3m_tpu_torch.training.workspace import Workspace

    device = init_distributed(cfg.get("distributed_init", "auto"), device=device)
    attempt = 0
    while True:
        ws = None
        try:
            # built inside the try: a crash while rebuilding the workspace (a transient
            # storage error, a device reset) is what the requeue is for
            ws = Workspace(cfg, device=device)
            _install_sigterm(ws)
            ws.train()
            return
        except KeyboardInterrupt:
            raise
        except Exception as e:  # the requeue boundary: report, then retry or re-raise
            attempt += 1
            if attempt > retries:
                raise
            print(f"[requeue] attempt {attempt}/{retries} after {type(e).__name__}: {e}")
        finally:
            if ws is not None:
                ws.close()


def _rank_main(cfg, device, retries: int) -> None:
    """A rank that this command started: it joins the job, whatever distributed_init says."""
    cfg["distributed_init"] = "true"
    _run(cfg, device, retries)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m r3m_tpu_torch.train_representation", allow_abbrev=False,
        description="R3M pretraining on one device or, one process a card, on several "
                    "(Hydra-style key=value overrides).")
    parser.add_argument("--config", default=DEFAULT_CONFIG, help="root YAML config")
    parser.add_argument("--retries", type=int, default=0,
                        help="rebuild the workspace after a crash, up to this many times")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: cuda:LOCAL_RANK in a job of several ranks), "
                             "cuda:N or cpu")
    parser.add_argument("overrides", nargs="*", help="key.path=value (+key=value adds)")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))

    import torch

    from r3m_tpu_torch.parallel.mesh import launch_local, launched
    from r3m_tpu_torch.training.workspace import data_parallel_world
    from r3m_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, overrides=args.overrides)
    n_ranks = data_parallel_world(cfg, torch.device(args.device))
    if n_ranks > 1 and not launched():
        # no launcher: one process a device, started here, as one JAX command uses the
        # node; a SIGTERM to this process reaches every rank
        launch_local(_rank_main, n_ranks, cfg, args.device, args.retries)
    else:
        _run(cfg, args.device, args.retries)


if __name__ == "__main__":
    main()
