"""Pretrain -> probe-delta artifact: does R3M training help downstream? The port of the JAX
repo's ``scripts/probe_delta.py``.

R3M's purpose is a reusable representation evaluated downstream (the reference's
behaviour-cloning evaluation; paper §4). This is the one-command in-repo form of that
evidence: pretrain the README config on the synthetic reach world
(`r3m_tpu_torch.evalsuite.fixtures`), then score THREE encoders on a held-out probe set —

  random   : fresh random inits (three other seeds),
  step0    : the training run's step-0 snapshot (controls for init/seed),
  trained  : the last rolling snapshot,

with (a) a ZERO-SHOT reward-ordering metric (is −L2 similarity to the goal frame monotone
in time on held-out videos — the model's own `sim`/reward semantics, no probe head
fitted), (b) the BC probe (frozen standardized embeddings -> reach action, split by
video), (c) closed-form linear probes on the world's ground-truth latents (block
position, goal position, progress) and (d) zero-shot caption contrast through the trained
reward head. Every fitted metric is reported mean±std over 3 video-holdout splits, and the
random baseline averages 3 independent inits — single-seed luck cannot masquerade as
signal. *Done* = trained ≫ random/step0 on the probe metrics; results go to
``$RUN/PROBE_DELTA.json`` and a markdown table.

Usage:
  python -m r3m_tpu_torch.probe_delta --run /tmp/r3m_probe --steps 2000
  python -m r3m_tpu_torch.probe_delta --run ... --skip-train   # probe-only rerun
  python -m r3m_tpu_torch.probe_delta --device cpu --run /tmp/p --steps 3 --size 18 \\
      --image-size 32 --videos 6 --frames 8 --probe-videos 6 --probe-frames 5 --workers 1

Training, embedding and the BC policy run on ``--device`` (the card unless named); the
fixtures and the linear probes are host numpy. ``PROBE_DELTA.json`` carries the JAX
script's keys, and ``seconds`` (fixture, train, probe set, embed, probes, caption
contrast) and ``train_frames_per_s`` (the frames trained in this call over the wall time
of `Workspace.train`, evaluations and snapshots included) beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np

_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfgs",
                       "config_rep.yaml")
RANDOM_SEEDS = (4242, 4243, 4244)

METRICS = (
    "bc_val_mse", "bc_dir_acc", "block_pos_r2", "goal_pos_r2",
    "progress_r2",
)


def _ensure_fixture(run: str, args) -> None:
    """The reach world's pretraining split (seed 3) and a frozen DistilBERT.

    The DistilBERT is random, of base geometry, drawn from torch seed 9: the published
    weights need a download (``prepare_language``), and a random frozen encoder still maps
    the 8 direction captions to distinct fixed embeddings, which is all the
    language-reward loss needs on this fixture. It is written as the JAX package's
    ``bert.npz`` (pytree and ``bert_config`` metadata). Its weights are not the JAX
    script's (``distilbert_init(PRNGKey(9))``): a JAX key cannot drive torch's generator.
    A ``bert.npz`` already in ``--run`` is kept, so the JAX draw, saved there with the JAX
    package's ``save_snapshot`` as its script does, makes the two probes comparable: on
    the same snapshots they give the same reward-order and caption-contrast accuracies
    (``tests/test_torch_probe_delta.py``, at its small settings: 0.806 and 0.889 reward
    order for the step-0 and trained snapshots, 0.0 caption contrast, in both).
    """
    import dataclasses

    import torch

    from r3m_tpu_torch.checkpoint import save_snapshot
    from r3m_tpu_torch.convert import distilbert_tree
    from r3m_tpu_torch.evalsuite.fixtures import write_probe_dataset
    from r3m_tpu_torch.models.distilbert import DistilBert

    data = os.path.join(run, "data")
    if not os.path.exists(os.path.join(data, "manifest.csv")):
        print(f"[probe] rendering pretraining split -> {data}")
        write_probe_dataset(data, n_videos=args.videos, n_frames=args.frames,
                            size=args.image_size, seed=3)
    bert_path = os.path.join(run, "bert.npz")
    if not os.path.exists(bert_path):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            bert = DistilBert()
        save_snapshot(bert_path, distilbert_tree(bert.state_dict()),
                      {"bert_config": dataclasses.asdict(bert.cfg)})


def _train(run: str, args) -> Optional[float]:
    """The README's pretraining config on the reach world; returns train frames/s (None
    when the run had no step left to take)."""
    from r3m_tpu_torch.training.workspace import Workspace
    from r3m_tpu_torch.utils.config import load_config

    cfg = load_config(
        _CONFIG,
        overrides=[
            f"datapath={os.path.join(run, 'data')}",
            f"log_dir={run}",
            f"batch_size={args.bs}",
            f"train_steps={args.steps}",
            f"eval_freq={max(100, args.steps // 4)}",
            "eval_batches=2",
            "keep_snapshots=2",
            f"num_workers={args.workers}",
            # the README train command's hyperparameters
            f"agent.size={args.size}",
            "agent.langweight=1.0",
            "agent.l1weight=1e-5",
            "lr=1e-4",
            f"doaug={args.doaug}",
            f"bert_weights={os.path.join(run, 'bert.npz')}",
            f"vocab_path={os.path.join(run, 'data', 'vocab.txt')}",
        ]
        + (
            # small CPU runs shrink the world; the card's run stays at 224
            [f"+agent.image_size={args.image_size}"] if args.image_size != 224 else []
        ),
    )
    ws = Workspace(cfg, work_dir=run, device=args.device)
    try:
        if ws.global_step == 0:
            # step-0 control snapshot (same init/seed as the run), kept under a name the
            # retention pruner ignores
            ws.save_snapshot()
            ws.flush_snapshots()
            shutil.copyfile(os.path.join(run, "snapshot_0.npz"),
                            os.path.join(run, "init_snapshot.npz"))
        step0 = ws.global_step
        t0 = time.perf_counter()
        ws.train()
        seconds = time.perf_counter() - t0
        print(f"[probe] trained to step {ws.global_step}")
        steps = ws.global_step - step0
    finally:
        ws.close()
    return steps * args.bs * 5 / seconds if steps else None


def _embed(enc, images: np.ndarray, chunk: int = 120) -> np.ndarray:
    from r3m_tpu_torch.evalsuite.bc import _embed_chunked

    return _embed_chunked(enc, images, chunk)


def _metrics_for_split(emb: np.ndarray, probe: dict, seed: int, device) -> dict:
    """One video-held-out split: standardized BC probe + linear probes."""
    from r3m_tpu_torch.evalsuite.bc import bc_probe
    from r3m_tpu_torch.evalsuite.fixtures import _host, linear_probe

    video = probe["video"]
    ids = np.unique(video)
    rng = np.random.default_rng(seed)
    rng.shuffle(ids)
    val_ids = ids[: max(1, len(ids) // 4)]
    val_mask = np.isin(video, val_ids)

    # Center + SCALAR-scale embeddings on TRAIN-split statistics before the BC head:
    # encoders differ wildly in feature scale (the L1 penalty vs a fresh init), and a
    # fixed-lr Adam MLP is not scale-invariant — without this the BC column confounds
    # representation quality with feature norm. Deliberately ONE scalar, not per-dim
    # whitening: per-dim sd amplifies dims that are near-constant on the train videos but
    # vary on held-out videos (sd -> eps floor, z -> 1e6). (linear_probe
    # ridge-standardizes internally, where the per-dim form is safe because the penalty
    # bounds the weights.)
    mu = emb[~val_mask].mean(0)
    s = float(emb[~val_mask].std()) + 1e-8
    z = (emb - mu) / s

    # BC probe trained on train videos; evaluated on HELD-OUT videos (frame-level splits
    # leak: adjacent frames are near-duplicates)
    res = bc_probe(
        embed_fn=lambda x: x,  # embeddings precomputed above
        images=z[~val_mask],
        actions=probe["actions"][~val_mask],
        steps=400,
        val_frac=0.1,
        seed=seed,
        device=device,
    )
    pred = _host(res["policy_apply"](res["policy_params"], z[val_mask]))
    bc_mse = float(np.mean((pred - probe["actions"][val_mask]) ** 2))
    # direction accuracy: does the policy at least point the right way? Goal frames carry
    # the exact zero action (render_probe_set's norm<=1e-6 branch): dot = 0 for ANY
    # prediction, so they have no direction to score and are left out of the denominator.
    acts = probe["actions"][val_mask]
    has_dir = np.linalg.norm(acts, axis=-1) > 1e-6
    dots = np.sum(pred * acts, axis=-1)
    bc_dir_acc = float(np.mean(dots[has_dir] > 0))

    return {
        "bc_val_mse": bc_mse,
        "bc_dir_acc": bc_dir_acc,
        "block_pos_r2": linear_probe(emb, probe["latents"][:, :2], groups=video,
                                     seed=seed)["r2_mean"],
        "goal_pos_r2": linear_probe(emb, probe["latents"][:, 2:4], groups=video,
                                    seed=seed)["r2_mean"],
        "progress_r2": linear_probe(emb, probe["progress"], groups=video,
                                    seed=seed)["r2_mean"],
    }


def _add_caption_contrast(rows, run, snap_path, snap_meta, probe, device) -> None:
    """Zero-shot language-reward discrimination (`fixtures.caption_contrast_acc`): does
    the TRAINED reward head pick the true direction caption out of all 8 for held-out
    (first, last) frame pairs? Chance 1/8; evidences the LANGUAGE loss specifically (the
    reference's get_reward-as-RL-reward deployment, paper §4.3). Skipped (with a note)
    when the run has no language head."""
    from r3m_tpu_torch.checkpoint import r3m_config_from_meta
    from r3m_tpu_torch.evalsuite.fixtures import caption_contrast_acc
    from r3m_tpu_torch.models.distilbert import load_bert
    from r3m_tpu_torch.models.r3m import r3m_init
    from r3m_tpu_torch.reward import R3MRewardModel
    from r3m_tpu_torch.text.tokenizer import WordPieceTokenizer

    try:
        bert_path = os.path.join(run, "bert.npz")
        vocab = os.path.join(run, "data", "vocab.txt")
        video = probe["video"]
        vids = np.unique(video)
        first = np.asarray([np.nonzero(video == v)[0][0] for v in vids])
        last = np.asarray([np.nonzero(video == v)[0][-1] for v in vids])
        deltas = probe["latents"][first, 2:4] - probe["latents"][first, :2]
        imgs_first, imgs_last = probe["images"][first], probe["images"][last]

        def acc_of(rm) -> float:
            return caption_contrast_acc(rm.get_reward, rm.embed(imgs_first),
                                        rm.embed(imgs_last), deltas)

        # fully random models (encoder + reward head + the same frozen BERT): the
        # chance-level baseline, averaged over 3 seeds
        full_cfg = r3m_config_from_meta(snap_meta, compute_dtype="float32")
        bert = load_bert(bert_path, device)
        tok = WordPieceTokenizer(vocab_file=vocab)
        lml = int(snap_meta.get("lang_max_len", 32))
        rnd_accs = [
            acc_of(R3MRewardModel(full_cfg, r3m_init(full_cfg, seed=k).state_dict(), bert,
                                  tok, lang_max_len=lml, device=device))
            for k in RANDOM_SEEDS
        ]
        accs = {
            "random_init(x3)": (float(np.mean(rnd_accs)), float(np.std(rnd_accs))),
            "step0_snapshot": (
                acc_of(R3MRewardModel.from_snapshot(
                    os.path.join(run, "init_snapshot.npz"), bert_path, vocab,
                    device=device)),
                0.0,
            ),
            "trained": (
                acc_of(R3MRewardModel.from_snapshot(snap_path, bert_path, vocab,
                                                    device=device)),
                0.0,
            ),
        }
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"[probe] lang caption-contrast skipped: {e}")
        return
    for r in rows:
        if r["encoder"] in accs:
            m, s = accs[r["encoder"]]
            r["lang_contrast_acc"] = m
            r["lang_contrast_acc_std"] = s
            print(f"[probe] lang_contrast_acc[{r['encoder']}] = {m:.3f}±{s:.3f} "
                  "(chance 0.125)")


def _probe_encoder(name: str, encs, probe, device, seconds: Dict[str, float],
                   split_seeds=(0, 1, 2)) -> dict:
    """Score one encoder variant (or a LIST of same-role encoders, e.g. several random
    inits) over several video-holdout splits; report mean ± std over every (encoder,
    split) sample so single-seed luck cannot masquerade as signal. Adds the embedding and
    probe seconds to `seconds`."""
    from r3m_tpu_torch.evalsuite.fixtures import reward_order_acc

    if not isinstance(encs, (list, tuple)):
        encs = [encs]
    samples: list = []
    order_accs = []
    for enc in encs:
        t0 = time.perf_counter()
        emb = _embed(enc, probe["images"])
        t1 = time.perf_counter()
        order_accs.append(reward_order_acc(emb, probe["video"]))
        for s in split_seeds:
            samples.append(_metrics_for_split(emb, probe, s, device))
        seconds["embed"] += t1 - t0
        seconds["probes"] += time.perf_counter() - t1
    out = {"encoder": name, "n_samples": len(samples)}
    for m in METRICS:
        vals = np.asarray([r[m] for r in samples])
        out[m] = float(vals.mean())
        out[m + "_std"] = float(vals.std())
    out["reward_order_acc"] = float(np.mean(order_accs))
    out["reward_order_acc_std"] = float(np.std(order_accs))
    print("[probe]", json.dumps(out))
    return out


def _print_table(rows) -> None:
    """The markdown table (mean ± std over (init, split) samples)."""

    def cell(r, m, prec=3):
        return f"{r[m]:.{prec}f}±{r[m + '_std']:.{prec}f}"

    has_lang = all("lang_contrast_acc" in r for r in rows)
    lang_hdr = " lang caption contrast (zero-shot, chance 0.125) |" if has_lang else ""
    print("\n| encoder | reward-order acc (zero-shot) |" + lang_hdr +
          " BC val MSE (held-out videos) | BC dir acc | "
          "block-pos R2 | goal-pos R2 | progress R2 |")
    print("|---|---|" + ("---|" if has_lang else "") + "---|---|---|---|---|")
    for r in rows:
        lang_cell = f" {cell(r, 'lang_contrast_acc')} |" if has_lang else ""
        print(
            f"| {r['encoder']} | {cell(r, 'reward_order_acc')} |" + lang_cell +
            f" {cell(r, 'bc_val_mse', 4)} | {cell(r, 'bc_dir_acc')} | "
            f"{cell(r, 'block_pos_r2')} | {cell(r, 'goal_pos_r2')} | "
            f"{cell(r, 'progress_r2')} |"
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m r3m_tpu_torch.probe_delta",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run", default="r3m_probe")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--bs", type=int, default=16)
    p.add_argument("--size", type=int, default=50)
    p.add_argument("--videos", type=int, default=64)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--probe-videos", type=int, default=48)
    p.add_argument("--probe-frames", type=int, default=30)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument(
        "--doaug", default="rctraj",
        help="augmentation mode (README default rctraj; 'none' is the crop-invariance "
        "ablation: absolute-position probes should recover when the objective stops "
        "training invariance to spatial crops)",
    )
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where training, embedding and the BC policy run (default cuda)")
    args = p.parse_args(argv)

    from r3m_tpu_torch import load_r3m_from_snapshot
    from r3m_tpu_torch.evalsuite.fixtures import render_probe_set
    from r3m_tpu_torch.models.r3m import R3MEncoder, r3m_init, resolve_device

    args.device = resolve_device(args.device)  # fail before any work without a card
    seconds = dict.fromkeys(("fixture", "train", "probe_set", "embed", "probes",
                             "caption_contrast"), 0.0)
    run = args.run
    os.makedirs(run, exist_ok=True)
    t0 = time.perf_counter()
    _ensure_fixture(run, args)
    seconds["fixture"] = time.perf_counter() - t0
    train_fps = None
    if not args.skip_train:
        t0 = time.perf_counter()
        train_fps = _train(run, args)
        seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cache = os.path.join(
        run, f"probe_set_{args.probe_videos}x{args.probe_frames}_{args.image_size}.npz")
    if os.path.exists(cache):
        print(f"[probe] loading cached probe set {cache}")
        with np.load(cache) as z:
            probe = dict(z)
    else:
        print("[probe] rendering held-out probe set")
        probe = render_probe_set(
            n_videos=args.probe_videos, n_frames=args.probe_frames, size=args.image_size,
            seed=10_000,  # disjoint from the training split's seed
        )
        np.savez(cache, **probe)  # rendering 224 px sets takes minutes
    seconds["probe_set"] = time.perf_counter() - t0

    snap_path = os.path.join(run, "snapshot.npz")
    trained = load_r3m_from_snapshot(snap_path, device=args.device)
    step0 = load_r3m_from_snapshot(os.path.join(run, "init_snapshot.npz"), device=args.device)
    # the rolling snapshot is the LAST EVAL-EVENT snapshot, which for eval_freq = steps//4
    # lands at ~3/4 of the run (training stops before the next event) — record the step
    # actually scored, not the nominal --steps (npz members load lazily, so this reads
    # only the meta blob)
    with np.load(snap_path) as z:
        snap_meta = json.loads(bytes(z["__meta__"]).decode())
    scored_step = int(snap_meta.get("global_step", -1))
    rnds = [R3MEncoder(trained.cfg, r3m_init(trained.cfg, seed=k).convnet.state_dict(),
                       device=args.device)
            for k in RANDOM_SEEDS]

    rows = [
        _probe_encoder("random_init(x3)", rnds, probe, args.device, seconds),
        _probe_encoder("step0_snapshot", step0, probe, args.device, seconds),
        _probe_encoder("trained", trained, probe, args.device, seconds),
    ]
    t0 = time.perf_counter()
    _add_caption_contrast(rows, run, snap_path, snap_meta, probe, args.device)
    seconds["caption_contrast"] = time.perf_counter() - t0
    result = {
        "steps": args.steps,
        "scored_snapshot_step": scored_step,
        "doaug": args.doaug,
        "size": args.size,
        "probe_frames": int(probe["images"].shape[0]),
        "rows": rows,
        "seconds": seconds,
        "train_frames_per_s": train_fps,
    }
    out_path = os.path.join(run, "PROBE_DELTA.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(f"[probe] wrote {out_path}")
    print(f"[probe] seconds {json.dumps(seconds)}; train frames/s {train_fps}")
    _print_table(rows)

    tr, rnd = rows[2], rows[0]
    print(json.dumps({
        "metric": "probe_delta_reward_order_acc_trained_minus_random",
        "value": round(tr["reward_order_acc"] - rnd["reward_order_acc"], 4),
        "unit": "accuracy delta (>0 = trained better)",
    }))
    print(json.dumps({
        "metric": "probe_delta_bc_mse_ratio_trained_vs_random",
        "value": round(tr["bc_val_mse"] / max(rnd["bc_val_mse"], 1e-9), 4),
        "unit": "ratio (<1 = trained better)",
    }))
    if "lang_contrast_acc" in tr:
        print(json.dumps({
            "metric": "probe_delta_lang_contrast_acc_trained",
            "value": round(tr["lang_contrast_acc"], 4),
            "unit": "8-way caption accuracy (chance 0.125)",
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
