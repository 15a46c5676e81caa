"""Where the fused RNN op's rnn_relu results part between the card and
the host: ReLU sign flips at pre-activations within a rounding step of 0.

    python3 tools/rnn_relu_flip_probe.py      # from the repository root, one card

Runs ``chip_smoke.py``'s gate (a) case for bidirectional rnn_relu (two
layers, T 35, N 32, 650 -> 650, the gate's inputs) on the card and on the
host in f32, recording every ReLU input, then again in f64. Prints one
JSON line with each tensor's f32 error against the host (as a fraction
of the host tensor's largest value), the number of ReLU units whose sign
differs between the two and their pre-activations, and one with the f64
errors.
"""
import importlib.util
import json
import os
import sys

import torch


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        sys.exit("rnn_relu_flip_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mxnet_tpu_torch as mt
    seed = 114                       # gate (a)'s seed for rnn_relu, two-way
    names = ["out", "h", "grad_data", "grad_params", "grad_state"]
    seen = []
    relu = torch.relu

    def recording(x):
        seen.append(x.detach().double().cpu())
        return relu(x)

    res = {}
    torch.relu = recording
    try:
        for dev, ctx in (("card", mt.gpu(0)), ("host", mt.cpu())):
            seen.clear()
            res[dev] = (cs._rnn_op_case(torch, mt, "rnn_relu", True, ctx,
                                        seed), list(seen))
    finally:
        torch.relu = relu

    def errs(got, want):
        return {n: float((a.double() - b.double()).abs().max()
                         / b.double().abs().max())
                for n, a, b in zip(names, got, want)}

    flips, gates = 0, []
    for a, b in zip(res["card"][1], res["host"][1]):
        f = (a > 0) != (b > 0)
        flips += int(f.sum())
        gates += [float(v) for v in b[f].abs().flatten()[:5]]
    print(json.dumps({
        "f32_errors": errs(res["card"][0], res["host"][0]),
        "relu_units": sum(b.numel() for b in res["host"][1]),
        "sign_flips": flips, "flipped_pre_activations": gates,
        "smallest_pre_activation": min(float(b.abs().min())
                                       for b in res["host"][1])}))
    f64 = [cs._rnn_op_case(torch, mt, "rnn_relu", True, ctx, seed,
                           torch.float64) for ctx in (mt.gpu(0), mt.cpu())]
    print(json.dumps({"f64_errors": errs(*f64)}))


if __name__ == "__main__":
    main()
