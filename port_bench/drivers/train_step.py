"""The pretraining window: back-to-back steps of ``r3m_tpu_torch``'s train step on a pool
of batches on the device.

Set-up draws the weights from the seed on the device, builds the state with
``create_train_state`` and the step with ``make_train_step(cfg, bert, doaug)``, and runs
the first ``checked_steps`` steps through that same step on distinct pool batches; those
steps warm every shape, and their losses, first gradients (from Adam's first moment) and
the parameters' change are the system's readings. The window then runs steps until its
time is up and ends on a synchronize. After it the state is freed and the plain
reference retraces the checked steps from the same weights, batches, crops and
negatives.
"""

from __future__ import annotations

import sys
import time
import traceback

import torch

from port_bench import compare, traffic, weights
from port_bench.reference import nets
from port_bench.reference import r3m as ref
from port_bench.reference.precision import Arith

BETA1 = 0.9  # torch Adam's first-moment decay: after one step it holds (1 - BETA1) * g


def seeds(seed: int) -> dict:
    return {"weights": seed, "bert": seed + 1, "traffic": seed + 2, "state": seed + 3}


def model_specs(cfg: dict):
    """The trained tensors, ``convnet.*`` and ``lang_rew.*``, with their laws."""
    bb, model = cfg["backbone"], cfg["model"]
    specs = nets.vit_specs(bb) if bb["kind"] == "vit" else nets.resnet_specs(bb)
    specs = [("convnet." + n, s, law) for n, s, law in specs]
    if model["langweight"] > 0:
        specs += [("lang_rew." + n, s, law) for n, s, law in nets.reward_specs(
            bb["out_dim"], model["hidden_dim"], cfg["language_model"]["dim"])]
    return specs


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault=None):
        from r3m_tpu_torch.models.distilbert import DistilBertConfig, bert_from_state
        from r3m_tpu_torch.models.r3m import R3MConfig, R3MModel
        from r3m_tpu_torch.training.trainer import create_train_state, make_train_step

        self.cfg, self.mix, self.device, self.fault = cfg, mix, device, fault
        self.seeds = seeds(seed)
        self.phases, t = {}, time.perf_counter()
        model = cfg["model"]
        self.rcfg = R3MConfig(**{k: model[k] for k in (
            "size", "hidden_dim", "l2weight", "l1weight", "langweight", "tcnweight", "l2dist",
            "num_negatives", "lr", "optimizer", "image_size", "compute_dtype")},
            lang_dim=cfg["language_model"]["dim"])
        lm = cfg["language_model"]
        bert = bert_from_state(self._bert(), DistilBertConfig(
            vocab_size=lm["vocab_size"], dim=lm["dim"], n_layers=lm["n_layers"],
            n_heads=lm["n_heads"], hidden_dim=lm["hidden_dim"],
            max_position_embeddings=lm["max_position_embeddings"],
            layer_norm_eps=lm["layer_norm_eps"]))
        with torch.device("meta"):
            net = R3MModel(self.rcfg)
        net.load_state_dict(self._weights(), assign=True)
        self.state = create_train_state(self.rcfg, seed=self.seeds["state"], model=net,
                                        device=device)
        self.step = make_train_step(self.rcfg, bert, doaug=mix["doaug"], device=device)
        self.pool = traffic.train_pool(mix, lm["vocab_size"], self.seeds["traffic"], device)
        sync(device)
        self.phases["state"], t = time.perf_counter() - t, time.perf_counter()
        self.readings = self._checked_steps()
        self.phases["checked_steps"] = time.perf_counter() - t

    def _weights(self):
        return weights.make_tensors(model_specs(self.cfg), self.seeds["weights"], self.device)

    def _bert(self):
        return weights.make_tensors(nets.bert_specs(self.cfg["language_model"]),
                                    self.seeds["bert"], self.device)

    def _call(self, batch):
        """The step as the window calls it, or with a planted fault."""
        if self.fault == "unchanged":
            return self.state, {"full_loss": torch.zeros((), device=self.device)}
        if self.fault == "half":
            keep = batch["images"].shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
        return self.step(self.state, batch)

    def _checked_steps(self) -> dict:
        model = self.state.model
        losses, grad, stats = [], {}, {}
        for k in range(self.mix["checked_steps"]):
            self.state, metrics = self._call(self.pool[k % len(self.pool)])
            losses.append(metrics["full_loss"].detach())
            if k == 0:
                moments = {n: self.state.optimizer.state[p]["exp_avg"] / (1 - BETA1)
                           for n, p in model.named_parameters()
                           if "exp_avg" in self.state.optimizer.state.get(p, {})}
                grad = compare.leaf_norms(moments) if moments else {
                    n: 0.0 for n, _ in model.named_parameters()}
                stats = {n: b.detach().float().cpu().clone() for n, b in model.named_buffers()
                         if n.endswith("running_var")}
        start = self._weights()
        now = dict(model.named_parameters())
        now.update((n, b) for n, b in model.named_buffers() if b.is_floating_point())
        change = compare.leaf_norms({n: now[n] - start[n] for n in now})
        sync(self.device)
        return {"losses": torch.stack(losses).tolist(), "grad": grad, "change": change,
                "stats": stats}

    def window(self, seconds: float, probe, spans) -> dict:
        clips, frames = self.mix["clips"], self.mix["frames"]
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        offset, losses, errors = self.mix["checked_steps"], [], 0
        probe.start()
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            try:
                self.state, metrics = self._call(self.pool[(offset + n) % len(self.pool)])
                losses.append(metrics["full_loss"].detach())
            except Exception:  # the window goes on; the step counts as failed
                if not errors:
                    traceback.print_exc(file=sys.stderr)
                errors += 1
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        probe.stop()
        nonfinite = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        return {"attempted": n, "failed": errors + nonfinite, "window_s": elapsed,
                "end_to_end": {"train_frames_per_s": n * clips * frames / elapsed,
                               "train_peak_gb": peak}}

    def release(self) -> None:
        self.state = self.step = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, arith: Arith, drop_half: bool = False) -> dict:
        """The reference's readings of the checked steps in `arith`'s precision."""
        cfg, mix = self.cfg, self.mix
        ref_state = ref.TrainRef(cfg, self._weights(), self._bert(), arith)
        start = {k: v.detach().clone() for k, v in ref_state.tensors().items()
                 if v.is_floating_point()}
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["state"])
        losses, grad, stats = [], {}, {}
        size = mix["frame_size"]
        for k in range(mix["checked_steps"]):
            crops = ref.draw_crops(gen, mix["clips"], size, size)
            perms = ref.draw_perms(gen, mix["clips"], cfg["model"]["num_negatives"])
            loss, grads = ref_state.step(self.pool[k % len(self.pool)], crops, perms,
                                         drop_half=drop_half)
            losses.append(loss)
            if k == 0:
                grad = compare.leaf_norms(grads)
                stats = {n: v.detach().float().cpu().clone() for n, v in ref_state.buffers.items()
                         if n.endswith("running_var")}
            del grads
        now = ref_state.tensors()
        change = compare.leaf_norms({n: now[n].detach() - start[n] for n in start})
        return {"losses": torch.stack(losses).tolist(), "grad": grad, "change": change,
                "stats": stats}

    def check(self) -> dict:
        return compare.train_gaps(self.readings, self.reference(Arith("f32")))
