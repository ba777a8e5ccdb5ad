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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m r3m_tpu_torch.train_representation", allow_abbrev=False,
        description="R3M pretraining on one device (Hydra-style key=value overrides).")
    parser.add_argument("--config", default=DEFAULT_CONFIG, help="root YAML config")
    parser.add_argument("--retries", type=int, default=0,
                        help="rebuild the workspace after a crash, up to this many times")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("overrides", nargs="*", help="key.path=value (+key=value adds)")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))

    from r3m_tpu_torch.training.workspace import Workspace
    from r3m_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, overrides=args.overrides)
    attempt = 0
    while True:
        ws = None
        try:
            # built inside the try: a crash while rebuilding the workspace (a transient
            # storage error, a device reset) is what the requeue is for
            ws = Workspace(cfg, device=args.device)
            _install_sigterm(ws)
            ws.train()
            return
        except KeyboardInterrupt:
            raise
        except Exception as e:  # the requeue boundary: report, then retry or re-raise
            attempt += 1
            if attempt > args.retries:
                raise
            print(f"[requeue] attempt {attempt}/{args.retries} after {type(e).__name__}: {e}")
        finally:
            if ws is not None:
                ws.close()


if __name__ == "__main__":
    main()
