"""One rank of the gloo group that tests/test_torch_distributed.py spawns.

One group serves every check: the contrastive loss and its gradients,
BatchNorm's global statistics, one `train_step` of the MLP compressor,
the global draws, and `main` of a banana preset under
`trainer.n_devices=2`. Each rank puts its results on the queue. This
module imports torch and the port only (no JAX), so a spawned rank starts
quickly. It also holds the bound that a test puts on the ranks it spawns
(`bounded`, `SPAWN_TIMEOUT_S`).
"""

import contextlib
import multiprocessing
import os
import signal

import torch
import torch.distributed as dist

from lossyless_tpu_torch.core import mesh

# a spawning test's bound: ranks that hang fail the test
SPAWN_TIMEOUT_S = 600


@contextlib.contextmanager
def bounded(seconds: int = SPAWN_TIMEOUT_S):
    """Fail the block if it runs longer than `seconds`, killing the
    processes it spawned."""
    def expire(signum, frame):
        raise TimeoutError(f"the spawned ranks ran over {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    except TimeoutError:
        for p in multiprocessing.active_children():
            p.kill()
            p.join()
        raise
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def run(rank: int, world: int, port: int, payload: dict, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    try:
        out = {"rank": rank}
        for name in ("contrastive", "batchnorm", "step", "draws", "main"):
            if name in payload:
                out[name] = CHECKS[name](rank, world, payload[name])
        queue.put(_numpy(out))
    finally:
        dist.destroy_process_group()


def _numpy(tree):
    """Tensors as numpy arrays: a tensor on a queue is shared through its
    sender's process, which exits before the parent reads it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _rows(t, rank, world):
    return mesh.shard_batch(t, rank, world)


def contrastive(rank, world, p):
    """Each config's local loss, the gradients of the local rows, and the
    module's gradients averaged over the ranks."""
    from lossyless_tpu_torch.compressors.distortions import (
        ContrastiveDistortion)

    res = []
    for cfg in p["cfgs"]:
        model = ContrastiveDistortion(
            p["z_dim"], cfg, torch.Generator().manual_seed(0))
        z = _rows(p["z"], rank, world).clone().requires_grad_()
        zp = _rows(p["z_pos"], rank, world).clone().requires_grad_()
        with mesh.data_parallel(rank, world, len(z)):
            d, logs = model(z, zp, training=True)
            loss = d.mean()
            loss.backward()
            mesh.average_gradients(model.parameters())
            means = mesh.reduce_logs({"loss": loss.detach(),
                                      "I_q_zm": logs["I_q_zm"]})
        res.append({"logs": means, "dz": z.grad, "dz_pos": zp.grad,
                    "params": {n: q.grad for n, q in
                               model.named_parameters()},
                    "n_negatives": logs["n_negatives"]})
    return res


def batchnorm(rank, world, p):
    """The output rows, running statistics and gradients of one training
    forward over this rank's rows."""
    from lossyless_tpu_torch.nn.layers import BatchNorm

    bn = BatchNorm(p["x"].shape[1])
    bn.load_state_dict(p["state"])
    x = _rows(p["x"], rank, world).clone().requires_grad_()
    c = _rows(p["c"], rank, world)
    with mesh.data_parallel(rank, world, len(x)):
        y = bn(x, training=True)
        ((y * c).sum() / len(x)).backward()
        mesh.average_gradients(bn.parameters())
    return {"y": y.detach(), "dx": x.grad, "mean": bn.mean.clone(),
            "var": bn.var.clone(), "dscale": bn.scale.grad,
            "dbias": bn.bias.grad}


def step(rank, world, p):
    """One `train_step` of the MLP compressor on this rank's rows, with
    the step's noise given (its rows of the global draw)."""
    from lossyless_tpu_torch.compressors.compressor import (
        LearnableCompressor)
    from lossyless_tpu_torch.train.state import OptimConfig, TrainState, \
        train_step

    model = LearnableCompressor(p["cfg"])
    model.load_state_dict(p["state"])
    state = TrainState.create(model, main=OptimConfig(lr=1e-3))
    batch = _rows(p["batch"], rank, world)
    noise = _rows(p["noise"], rank, world)
    with mesh.data_parallel(rank, world, len(batch[0])):
        state, logs = train_step(state, batch, noise=noise)
    return {"state": model.state_dict(),
            "logs": {k: float(v) for k, v in logs.items()}}


def draws(rank, world, p):
    """The rate's noise, the two-view step's noise and a banana batch drawn
    in a data-parallel step: this rank's rows of one device's draws."""
    from lossyless_tpu_torch.compressors.rates import uniform_noise
    from lossyless_tpu_torch.data.banana import device_sample_batch

    rows = p["rows"]
    g = torch.Generator().manual_seed(5)
    with mesh.data_parallel(rank, world, rows):
        noise = uniform_noise((rows, 3), g, "cpu")
        with mesh.views(2):
            two = uniform_noise((2 * rows, 3), g, "cpu")
        banana = device_sample_batch(g, rows)
    return {"noise": noise, "two_views": two, "banana": banana}


def main(rank, world, p):
    """`main` of the preset in this group (torchrun's path): rank 0's
    metrics, the others' empty dict."""
    from lossyless_tpu_torch.pipeline.run import main as run_main

    return run_main(p["cfg"], device="cpu")


CHECKS = {"contrastive": contrastive, "batchnorm": batchnorm, "step": step,
          "draws": draws, "main": main}
