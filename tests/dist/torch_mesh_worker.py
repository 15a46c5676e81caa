"""Mesh cases of the port on gloo ranks (``tests/test_torch_mesh.py``,
``test_torch_transformer_mesh.py``, ``test_torch_spmd_mesh.py``).

    python -m mxnet_tpu_torch.launch -n N python tests/dist/torch_mesh_worker.py \\
        OUT CASE [CASE ...]

Every rank runs every case; rank 0 writes ``OUT/<case>.npz`` with the
gathered (global) results. Inputs are made with numpy from fixed seeds, or
read from ``OUT/inputs.npz`` (the JAX side's initial weights, written by
the test before the launch). Cases:

- ``coll``: every mesh collective on a ``{dp: N}`` mesh, forward and the
  gradients of ``sum(out * w)``.
- ``ring_causal`` / ``ring_full``: ring attention over ``{sp: N}``,
  output and the gradients of q, k, v.
- ``pipe``: ``pipeline_apply`` over ``{pp: N}``, 4 microbatches.
- ``tf_tp`` / ``tf_sp`` / ``tf_dp`` / ``tf_pp`` / ``tf_ep`` / ``tf_tpep``:
  three transformer train steps (``tf_pp``: the pipeline step, 2
  microbatches; ``tf_ep`` / ``tf_tpep``: the MoE LM), the losses and the
  gathered weights.
- ``spmd_dp`` / ``spmd_plan``: ``SPMDTrainer`` over ``{dp: N}`` on a thin
  channel-last ResNetV1 (K=1 then K=2 ``run_steps``; ``spmd_plan`` with the
  classifier's weight split over dp), losses, weights, momenta and
  running statistics.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import kvstore_server  # noqa: E402
from mxnet_tpu_torch.parallel import collectives as C  # noqa: E402
from mxnet_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mxnet_tpu_torch.parallel.sharding import P, gather, local_block  # noqa

TF_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE_CFG = dict(TF_CFG, n_experts=4, moe_every=1, capacity_factor=1.25)
TF_MESH = {"tf_tp": {"tp": 2}, "tf_sp": {"sp": 2}, "tf_dp": {"dp": 2},
           "tf_pp": {"pp": 2}, "tf_ep": {"ep": 2},
           "tf_tpep": {"ep": 2, "tp": 2}}
B, T, LR = 4, 16, 0.1


def tf_tokens():
    rs = np.random.RandomState(3)
    return rs.randint(0, 64, (B, T)), rs.randint(0, 64, (B, T))


def ring_inputs():
    rs = np.random.RandomState(5)
    q, k, v, w = (rs.randn(2, 16, 2, 8).astype(np.float32)
                  for _ in range(4))
    return q, k, v, w


def pipe_inputs(S):
    rs = np.random.RandomState(7)
    return (rs.randn(S, 8, 8).astype(np.float32) * 0.5,
            rs.randn(8, 8).astype(np.float32))


def case_coll(n):
    mesh = make_mesh({"dp": n})
    r = mesh.axis_index("dp")
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(2 * n, 4).astype(np.float32))
    w = torch.from_numpy(rs.randn(2 * n, 4).astype(np.float32))
    blk = x.chunk(n)[r].clone().requires_grad_()
    wblk = w.chunk(n)[r]
    out = {}
    # allreduce of the block (sum): every rank the sum of the blocks
    y = C.allreduce(blk, mesh, "dp")
    (g,) = torch.autograd.grad((y * wblk).sum(), blk)
    out["allreduce"] = y.detach().numpy()
    out["allreduce_grad"] = gather(g, P("dp"), mesh).numpy()
    # allgather of the blocks along axis 0
    y = C.allgather(blk, mesh, "dp", tiled_axis=0)
    (g,) = torch.autograd.grad((y * w).sum(), blk)
    out["allgather"] = y.detach().numpy()
    out["allgather_grad"] = gather(g, P("dp"), mesh).numpy()
    # reduce_scatter of the replicated x
    xr = x.clone().requires_grad_()
    y = C.reduce_scatter(xr, mesh, "dp", scatter_axis=0)
    (g,) = torch.autograd.grad((y * wblk).sum(), xr)
    out["reduce_scatter"] = gather(y.detach(), P("dp"), mesh).numpy()
    out["reduce_scatter_grad"] = g.numpy()
    # broadcast from axis index 1 (root)
    y = C.broadcast(blk, mesh, "dp", root=n - 1)
    out["broadcast"] = y.detach().numpy()
    # ring shift by one
    y = C.ppermute_ring(blk, mesh, "dp", shift=1)
    (g,) = torch.autograd.grad((y * wblk).sum(), blk)
    out["ppermute"] = gather(y.detach(), P("dp"), mesh).numpy()
    out["ppermute_grad"] = gather(g, P("dp"), mesh).numpy()
    # all_to_all: split the columns, concat the rows
    y = C.all_to_all(blk, mesh, "dp", split_axis=1, concat_axis=0)
    out["all_to_all"] = gather(y.detach(), P(None, "dp"), mesh).numpy()
    # d/dy of sum(y * stop(y)) is y: the backward all-to-all returns x
    (g,) = torch.autograd.grad((y * y.detach()).sum(), blk)
    out["all_to_all_grad"] = gather(g, P("dp"), mesh).numpy()
    # max and the bandwidth probe
    out["max"] = C.allreduce(blk.detach(), mesh, "dp", op="max").numpy()
    out["bw"] = np.float64(C.measure_allreduce_bandwidth(
        mesh, size_mb=0.5, axis="dp", iters=2, device="cpu"))
    C.barrier(mesh)
    return out


def case_ring(causal):
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    n = C.world()
    mesh = make_mesh({"sp": n})
    q, k, v, w = (torch.from_numpy(a) for a in ring_inputs())
    spec = P(None, "sp")
    blocks = [local_block(a, spec, mesh).requires_grad_()
              for a in (q, k, v)]
    wb = local_block(w, spec, mesh)
    o = ring_attention(*blocks, mesh, axis="sp", causal=causal)
    grads = torch.autograd.grad((o * wb).sum(), blocks)
    res = {"out": gather(o.detach(), spec, mesh).numpy()}
    for name, g in zip("qkv", grads):
        res[f"d{name}"] = gather(g, spec, mesh).numpy()
    return res


def case_pipe():
    from mxnet_tpu_torch.parallel.pipeline import pipeline_apply
    S = C.world()
    mesh = make_mesh({"pp": S})
    ws, x = (torch.from_numpy(a) for a in pipe_inputs(S))
    wl = ws[mesh.axis_index("pp")].clone().requires_grad_()
    xl = x.clone().requires_grad_()
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), wl, xl, mesh,
                       axis="pp", n_microbatches=4)
    # the loss is the same on every stage: each seeds its share
    gw, gx = torch.autograd.grad(y.sum() / S, [wl, xl])
    gx = C.allreduce(gx, mesh, "pp")
    return {"y": y.detach().numpy(),
            "dw": gather(gw[None], P("pp"), mesh).numpy(),
            "dx": gx.numpy()}


def case_tf(name, inputs):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import transformer as ttf
    moe = name in ("tf_ep", "tf_tpep")
    cfg = ttf.TransformerConfig(**(MOE_CFG if moe else TF_CFG))
    mesh = make_mesh(TF_MESH[name])
    glob = ttf.nest_params({k[len("tf/" + ("moe/" if moe else "dense/")):]:
                            v for k, v in inputs.items()
                            if k.startswith("tf/" + ("moe/" if moe
                                                      else "dense/"))})
    tok, tgt = tf_tokens()
    losses = []
    if name == "tf_pp":
        whole = convert.from_transformer_params(glob, cfg, device="cpu")
        step, prepare = ttf.make_pipeline_train_step(cfg, mesh, lr=LR,
                                                     n_microbatches=2)
        pp = prepare(whole)
        for _ in range(3):
            loss, pp = step(pp, tok, tgt)
            losses.append(float(loss))
        # back to the global pytree: stage s holds layers s*L/S ...
        S = mesh.axis_size("pp")
        lps = cfg.n_layers // S
        flat = {"embed": pp["embed"], "ln_f_scale": pp["ln_f_scale"],
                "ln_f_bias": pp["ln_f_bias"]}
        for j, lp in enumerate(pp["stages"]):
            for k, v in ttf.flat_params(lp).items():
                g = gather(v[None], P("pp"), mesh)
                for s in range(S):
                    flat[f"layer{s * lps + j}/{k}"] = g[s]
        params = flat
    else:
        step, shard = ttf.make_train_step(cfg, mesh, lr=LR)
        local = convert.from_transformer_params(glob, cfg, device="cpu",
                                                mesh=mesh)
        for _ in range(3):
            loss, local = step(local, tok, tgt)
            losses.append(float(loss))
        params = ttf.flat_params(ttf.gather_params(local, cfg, mesh))
    res = {f"param/{k}": v.float().numpy() for k, v in params.items()}
    res["losses"] = np.asarray(losses)
    return res


def case_spmd(name, inputs):
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    from mxnet_tpu_torch.parallel import SPMDTrainer
    from mxnet_tpu_torch.parallel.sharding import ShardingPlan
    mesh = make_mesh({"dp": C.world()})
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                   classes=10, layout="NHWC", stem_s2d=True, device="cpu",
                   prefix="net_")
    # by position: the JAX block names carry its process-wide counters
    items = list(net.collect_params().items())
    for i, (_, p) in enumerate(items):
        p.set_data(inputs[f"spmd/init/{i:03d}"])
    plan = ShardingPlan([(r"dense\d+_weight", P("dp", None))]) \
        if name == "spmd_plan" else None
    tr = SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                     plan=plan, optimizer="sgd",
                     optimizer_params={"learning_rate": 0.05,
                                       "momentum": 0.9})
    data = torch.from_numpy(inputs["spmd/data"])
    label = torch.from_numpy(inputs["spmd/label"])
    index = {k: i for i, (k, _) in enumerate(items)}
    res = {"loss1": tr.run_steps(data[:1], label[:1]).numpy()}
    tr.sync_block_params()
    for k, p in items:
        res[f"step1/{index[k]:03d}"] = p.tensor.detach().numpy().copy()
    res["loss23"] = tr.run_steps(data[1:], label[1:]).numpy()
    tr.sync_block_params()
    for k, p in items:
        res[f"param/{index[k]:03d}"] = p.tensor.detach().numpy()
    for k, m in tr.optimizer_state.items():
        if k in tr._blocks:
            m = gather(m, tr._specs[k], mesh)
        res[f"mom/{index[k]:03d}"] = m.detach().numpy()
    res["mode"] = np.asarray(tr.run_steps_mode)
    res["eager_steps"] = np.asarray(tr.eager_mesh_steps)
    return res


def main():
    out_dir, cases = sys.argv[1], sys.argv[2:]
    with mx.cpu():
        kvstore_server.init_distributed()
        inp_path = os.path.join(out_dir, "inputs.npz")
        inputs = dict(np.load(inp_path)) if os.path.exists(inp_path) else {}
        for case in cases:
            torch.manual_seed(0)
            if case == "coll":
                res = case_coll(C.world())
            elif case.startswith("ring_"):
                res = case_ring(case == "ring_causal")
            elif case == "pipe":
                res = case_pipe()
            elif case.startswith("tf_"):
                res = case_tf(case, inputs)
            elif case.startswith("spmd_"):
                res = case_spmd(case, inputs)
            else:
                raise SystemExit(f"unknown case {case}")
            if C.rank() == 0:
                np.savez(os.path.join(out_dir, f"{case}.npz"), **res)
            C.barrier()
    print(f"rank {C.rank()} MESH_WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
