"""The mesh examples' recipes on the port's ranks (run through
``python -m mxnet_tpu_torch.launch -n N``): the port's counterparts of
``examples/long_context/train_long_context.py`` and
``examples/model_parallel/matrix_factorization.py``. Those two scripts
drive JAX itself (``jax.random``, ``jax.jit``, ``NamedSharding``), so
aliasing ``mxnet_tpu`` to the port cannot run them; the recipes below are
the same programs written against the port's mesh API, checked against
the JAX examples' own functions by ``tests/test_torch_mesh.py`` and run at
the examples' default sizes on the card by ``chip_smoke.py``.

    torch_mesh_examples.py long_context OUT [--dp N --sp N ...]
    torch_mesh_examples.py matrix_factorization OUT [--mp N ...]
    torch_mesh_examples.py long_context,matrix_factorization OUT ...

- ``long_context``: a decoder-only LM (RMS pre-norm, ring attention over
  the mesh's ``sp`` axis, causal, ReLU FFN, an untied output matrix) on
  the example's period-16 task, batch over ``dp`` and sequence over
  ``sp``, Adam inline; the weights come from ``OUT/init.npz`` when it
  exists (the JAX example's ``build_params``), else from a seeded torch
  generator.
- ``matrix_factorization``: user and item embedding tables split by rows
  over ``mp`` (each rank holds its rows; a lookup masks the ids outside
  them and sums over ``mp``), the batch over ``dp``, SGD on the MSE of
  the dot products, the example's synthetic ratings.

Rank 0 writes ``OUT/<recipe>.npz`` (the losses, and the gathered final
weights) and prints the example's lines.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _rms(x):
    import torch
    return x / (torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)) + 1e-6)


def lc_forward(params, tokens, mesh, n_heads):
    """tokens (B_local, T_local) -> logits; the JAX example's forward."""
    import torch
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    x = params["embed"][tokens]
    b, t, d = x.shape
    hd = d // n_heads
    for layer in params["layers"]:
        h = _rms(x)
        q, k, v = (z.reshape(b, t, n_heads, hd)
                   for z in (h @ layer["qkv"]).split(d, dim=-1))
        att = ring_attention(q, k, v, mesh, axis="sp", causal=True)
        x = x + att.reshape(b, t, d) @ layer["proj"]
        h = _rms(x)
        x = x + torch.relu(h @ layer["ff1"]) @ layer["ff2"]
    return x @ params["out"]


def _leaves(params):
    return [params["embed"], params["out"]] + [
        layer[k] for layer in params["layers"]
        for k in ("qkv", "proj", "ff1", "ff2")]


def long_context(out, args):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel.collectives import cross_process_allreduce
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.parallel.sharding import (P, local_block,
                                                   reduce_unsplit)
    mesh = make_mesh({"dp": args.dp, "sp": args.sp})
    dev = mt.context.resolve_device(None)
    init = os.path.join(out, "init.npz")
    if os.path.exists(init):
        z = np.load(init)
        params = {"embed": z["embed"], "out": z["out"], "layers": [
            {k: z[f"layers/{i}/{k}"] for k in ("qkv", "proj", "ff1", "ff2")}
            for i in range(args.layers)]}
        params = {"embed": torch.from_numpy(params["embed"]),
                  "out": torch.from_numpy(params["out"]),
                  "layers": [{k: torch.from_numpy(v) for k, v in l.items()}
                             for l in params["layers"]]}
    else:
        g = torch.Generator().manual_seed(0)
        d, f, V = args.d_model, 4 * args.d_model, args.vocab

        def rnd(*shape):
            return torch.randn(shape, generator=g) * 0.02
        params = {"embed": rnd(V, d), "out": rnd(d, V), "layers": [
            {"qkv": rnd(d, 3 * d), "proj": rnd(d, d), "ff1": rnd(d, f),
             "ff2": rnd(f, d)} for _ in range(args.layers)]}
    params = {"embed": params["embed"].to(dev), "out": params["out"].to(dev),
              "layers": [{k: v.to(dev) for k, v in l.items()}
                         for l in params["layers"]]}
    rs = np.random.RandomState(0)
    period = 16
    pat = rs.randint(1, args.vocab, (args.batch, period))
    reps = (args.seq_len + period) // period + 1
    fixed = np.tile(pat, (1, reps))[:, :args.seq_len + 1]
    spec = P("dp", "sp")
    tok = local_block(torch.from_numpy(fixed[:, :-1].astype(np.int64)),
                      spec, mesh).to(dev)
    tgt = local_block(torch.from_numpy(fixed[:, 1:].astype(np.int64)),
                      spec, mesh).to(dev)
    n_global = args.batch * args.seq_len
    leaves = _leaves(params)
    m = [torch.zeros_like(w) for w in leaves]
    v = [torch.zeros_like(w) for w in leaves]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses = []
    for i in range(args.steps):
        ws = [w.detach().requires_grad_() for w in leaves]
        it = iter(ws)
        p = {"embed": next(it), "out": next(it), "layers": [
            {k: next(it) for k in ("qkv", "proj", "ff1", "ff2")}
            for _ in params["layers"]]}
        logits = lc_forward(p, tok, mesh, args.n_heads)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        share = nll.sum() / n_global     # this rank's tokens' share
        grads = reduce_unsplit(torch.autograd.grad(share, ws),
                               [P()] * len(ws), mesh)
        t = i + 1
        lr_t = args.lr * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t)
        with torch.no_grad():
            for w, mi, vi, gi in zip(leaves, m, v, grads):
                mi.mul_(b1).add_(gi, alpha=1 - b1)
                vi.mul_(b2).add_(gi * gi, alpha=1 - b2)
                w.sub_(lr_t * mi / (vi.sqrt() + eps))
        loss = float(cross_process_allreduce(share.detach().clone()))
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f}", flush=True)
    print(f"done (loss {losses[0]:.3f} -> {losses[-1]:.3f})", flush=True)
    return {"losses": np.asarray(losses),
            **{f"w{j}": w.detach().cpu().numpy()
               for j, w in enumerate(leaves)}}


def mf_data(num_users, num_items, n=200000):
    rs = np.random.RandomState(0)
    u_true = rs.randn(num_users, 8).astype(np.float32)
    i_true = rs.randn(num_items, 8).astype(np.float32)
    users = rs.randint(0, num_users, n).astype(np.int64)
    items = rs.randint(0, num_items, n).astype(np.int64)
    ratings = np.sum(u_true[users] * i_true[items], axis=1).astype(np.float32)
    return users, items, ratings


def _lookup(table, ids, mesh):
    """Rows of a table split over ``mp``: the local rows' lookup, masked,
    summed over ``mp``."""
    from mxnet_tpu_torch.parallel.collectives import allreduce
    rows = table.shape[0]
    local = ids - mesh.axis_index("mp") * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * inside[:, None].to(table.dtype)
    return allreduce(out, mesh, "mp")


def matrix_factorization(out, args):
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel.collectives import cross_process_allreduce
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.parallel.sharding import (P, gather, local_block,
                                                   reduce_unsplit)
    mesh = make_mesh({"dp": args.dp, "mp": args.mp})
    dev = mt.context.resolve_device(None)
    users, items, ratings = mf_data(args.num_users, args.num_items)
    init = os.path.join(out, "init.npz")
    if os.path.exists(init):
        z = np.load(init)
        ue, ie = torch.from_numpy(z["user_embed"]), \
            torch.from_numpy(z["item_embed"])
    else:
        g = torch.Generator().manual_seed(0)
        ue = torch.randn((args.num_users, args.factors), generator=g) * 0.01
        ie = torch.randn((args.num_items, args.factors), generator=g) * 0.01
    spec = P("mp", None)
    tables = [local_block(ue, spec, mesh).to(dev),
              local_block(ie, spec, mesh).to(dev)]
    losses = []
    for s in range(args.steps):
        b0 = (s * args.batch_size) % (len(users) - args.batch_size)
        sl = slice(b0, b0 + args.batch_size)
        u, i, r = (local_block(torch.from_numpy(a[sl]), P("dp"), mesh)
                   .to(dev) for a in (users, items, ratings))
        ws = [t.detach().requires_grad_() for t in tables]
        pred = (_lookup(ws[0], u, mesh) * _lookup(ws[1], i, mesh)).sum(1)
        # this rank's share: its samples over the batch, over the mp ranks
        # that compute the same samples
        share = ((pred - r) ** 2).sum() / (args.batch_size * args.mp)
        grads = reduce_unsplit(torch.autograd.grad(share, ws), [spec, spec],
                               mesh)
        with torch.no_grad():
            for t, gr in zip(tables, grads):
                t.sub_(args.lr * gr)
        loss = float(cross_process_allreduce(share.detach().clone()))
        losses.append(loss)
        if s % 20 == 0:
            print(f"step {s}: mse {loss:.4f}", flush=True)
    print(f"final mse {losses[-1]:.4f}", flush=True)
    return {"losses": np.asarray(losses),
            "user_embed": gather(tables[0], spec, mesh).cpu().numpy(),
            "item_embed": gather(tables[1], spec, mesh).cpu().numpy()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("recipes", help="long_context and / or "
                    "matrix_factorization, comma-separated")
    ap.add_argument("out")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=2)
    # long_context (the example's defaults)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=257)
    # matrix_factorization (the example's defaults)
    ap.add_argument("--num-users", type=int, default=5000)
    ap.add_argument("--num-items", type=int, default=2000)
    ap.add_argument("--factors", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    args = ap.parse_args()
    import contextlib
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import collectives as C
    recipes = {"long_context": (long_context, 20, 3e-3),
               "matrix_factorization": (matrix_factorization, 100, 0.05)}
    steps, lr = args.steps, args.lr
    with (mt.cpu() if args.cpu else contextlib.nullcontext()):
        kvstore_server.init_distributed()
        for name in args.recipes.split(","):
            fn, args.steps, args.lr = recipes[name]
            args.steps, args.lr = steps or args.steps, lr or args.lr
            res = fn(args.out, args)
            if C.rank() == 0:
                np.savez(os.path.join(args.out, f"{name}.npz"), **res)
            C.barrier()


if __name__ == "__main__":
    main()
