"""One rank of the port's data-parallel steps, for the CPU tests of `r3m_tpu_torch.parallel`
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_workspace.py``). It holds no
test itself and imports no JAX: it runs in the processes that `launch_local` spawns, which
join a gloo group.

`run_step(job)` reads the inputs the test wrote (``job["inputs"]``: the model, the frozen
DistilBERT, the global batch, crops and permutations), runs this rank's rows through the
port's data-parallel train or eval step, and writes what the test compares to
``job["out"] % rank``. ``job["variant"]`` breaks the step on purpose, to show the
comparison would see it: ``"summed"`` sums the gradients over the ranks instead of
averaging them, ``"local_bn"`` normalises with each rank's own BatchNorm statistics.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

from r3m_tpu_torch.models import resnet
from r3m_tpu_torch.models.r3m import R3MConfig
from r3m_tpu_torch.parallel import collectives
from r3m_tpu_torch.parallel.mesh import init_distributed, local_rows
from r3m_tpu_torch.training import trainer


def _summed(params, group=None):
    """`average_gradients` without the division by the world size."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, s in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(s.view_as(g))


def _record_collectives(log: list) -> None:
    """Wrap the torch.distributed calls the collectives make, logging (kind, shape)."""
    for kind in ("all_gather", "all_reduce", "broadcast"):
        real = getattr(dist, kind)

        def spy(*args, _real=real, _kind=kind, **kw):
            t = args[1] if _kind == "all_gather" else args[0]
            log.append((_kind, tuple(t.shape)))
            return _real(*args, **kw)

        setattr(dist, kind, spy)


def run_step(job: dict) -> None:
    init_distributed("true", device="cpu")
    torch.set_num_threads(job.get("threads", 1))
    world, rank = dist.get_world_size(), dist.get_rank()
    if job.get("variant") == "summed":
        trainer.average_gradients = _summed
    elif job.get("variant") == "local_bn":
        resnet._bn_train_synced = lambda y, bn, group: resnet._bn_train(y, bn)
    inp = torch.load(job["inputs"], weights_only=False)
    cfg = R3MConfig(**inp["cfg"])
    grad_accum = job.get("grad_accum", 1)
    batch = inp["batch"]
    rows = local_rows(batch["images"].shape[0], grad_accum, world, rank)
    local = {k: v[rows] for k, v in batch.items()}
    state = trainer.create_train_state(cfg, 0, model=copy.deepcopy(inp["model"]), device="cpu")
    log: list = []
    _record_collectives(log)
    collectives.reset_tally()
    if job["kind"] == "eval":
        step = trainer.make_eval_step(cfg, inp["bert"], device="cpu", mesh=True)
        metrics = step(state, local, perms=inp["perms"])
    else:
        step = trainer.make_train_step(cfg, inp["bert"], doaug=job.get("doaug", "rctraj"),
                                       grad_accum=grad_accum, device="cpu", mesh=True)
        state, metrics = step(state, local, perms=inp["perms"], crops=inp.get("crops"))
    torch.save({
        "metrics": {k: v.detach() for k, v in metrics.items()},
        "grads": {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None},
        "state": state.model.state_dict(),
        "collectives": log,
        "tally": collectives.read_tally(),
        "step": state.step,
    }, job["out"] % rank)


def fail_on_rank_1(marker: str) -> None:
    """Rank 1 raises at once; rank 0 waits in a collective for it (and writes `marker`
    first, to show it ran)."""
    init_distributed("true", device="cpu")
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    open(marker, "w").close()
    dist.barrier()


def sleep_forever() -> None:
    import time

    while True:
        time.sleep(1)


def stop_on_rank_1(config: str, overrides: list, work: str, out: str) -> None:
    """A `Workspace` rank that trains until told to stop: rank 1 is asked (as its SIGTERM
    handler would) after its second step. Writes the step it stopped after."""
    from r3m_tpu_torch.training.workspace import Workspace
    from r3m_tpu_torch.utils.config import load_config

    torch.set_num_threads(1)
    ws = Workspace(load_config(config, overrides=overrides), work_dir=work, device="cpu")
    try:
        if dist.get_rank() == 1:
            step = ws.train_step

            def step_then_stop(state, batch):
                state, metrics = step(state, batch)
                if state.step == 2:
                    ws.request_stop()
                return state, metrics

            ws.train_step = step_then_stop
        ws.train()
    finally:
        ws.close()
    with open(out % dist.get_rank(), "w") as f:
        f.write(str(ws.global_step))
