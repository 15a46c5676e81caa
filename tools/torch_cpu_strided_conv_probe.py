"""Probe PyTorch's CPU channels-last 1x1 strided convolution (no port code).

For each case, the weight gradient of one ``F.conv2d`` (1x1, stride 2,
``channels_last``, batch 4) at N intra-op threads is held against the
same call at 1 thread, and so is a thin ResNet-18 v1 ([2,2,2,2], widths
8-64) written in plain ``torch.nn``. Each case runs in its own process,
since the faulty builds may crash; a crash prints ``crash (rc)``.

    python tools/torch_cpu_strided_conv_probe.py [--threads 8]

Prints one line per case: the worst relative difference of the weight
gradient (the net: its worst parameter) against 1 thread.
"""
import argparse
import subprocess
import sys

CONV = """
import torch, torch.nn.functional as F
T, N, C, O, H, K, S, CL = {args}
fmt = torch.channels_last if CL else torch.contiguous_format
def grad(threads):
    torch.set_num_threads(threads)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, C, H, H, generator=g).contiguous(memory_format=fmt)
    w = torch.randn(O, C, K, K, generator=g).contiguous(memory_format=fmt)
    w.requires_grad_()
    y = F.conv2d(x.requires_grad_(), w, None, S, K // 2)
    y.backward(torch.randn(y.shape, generator=g).contiguous(
        memory_format=fmt))
    return w.grad
a, b = grad(1), grad(T)
print(float((a - b).abs().max() / a.abs().max()))
"""

NET = """
import torch, torch.nn as nn, torch.nn.functional as F
T, SIZE, CL = {args}
class Block(nn.Module):
    def __init__(s, cin, c, stride):
        super().__init__()
        s.c1 = nn.Conv2d(cin, c, 3, stride, 1, bias=False)
        s.c2 = nn.Conv2d(c, c, 3, 1, 1, bias=False)
        s.b1, s.b2 = nn.BatchNorm2d(c), nn.BatchNorm2d(c)
        s.down = None if cin == c and stride == 1 else nn.Sequential(
            nn.Conv2d(cin, c, 1, stride, bias=False), nn.BatchNorm2d(c))
    def forward(s, x):
        r = x if s.down is None else s.down(x)
        return F.relu(s.b2(s.c2(F.relu(s.b1(s.c1(x))))) + r)
def net():
    ch, blocks = (8, 8, 16, 32, 64), []
    for i in range(4):
        blocks += [Block(ch[i], ch[i + 1], 1 if i == 0 else 2),
                   Block(ch[i + 1], ch[i + 1], 1)]
    return nn.Sequential(nn.Conv2d(3, 8, 7, 2, 3, bias=False),
                         nn.BatchNorm2d(8), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                         *blocks, nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                         nn.Linear(64, 10))
def grads(threads):
    torch.set_num_threads(threads)
    torch.manual_seed(0)
    m = net()
    fmt = torch.channels_last if CL else torch.contiguous_format
    m = m.to(memory_format=fmt)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(4, 3, SIZE, SIZE, generator=g).contiguous(
        memory_format=fmt)
    F.cross_entropy(m(x), torch.randint(0, 10, (4,), generator=g)).backward()
    return [p.grad for p in m.parameters()]
print(max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-12))
          for a, b in zip(grads(1), grads(T))))
"""


def _run(body, args):
    proc = subprocess.run([sys.executable, "-c", body.format(args=args)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        return f"crash ({proc.returncode})"
    return proc.stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=8)
    t = ap.parse_args().threads
    for c, o in ((3, 8), (8, 16), (16, 32)):
        for h in (12, 16, 24, 32):
            for k, cl in ((1, 1), (1, 0), (3, 1)):
                args = (t, 4, c, o, h, k, 2, cl)
                print(f"conv {c}->{o} {h}x{h} {k}x{k} stride 2 "
                      f"{'channels_last' if cl else 'nchw'} {t} threads: "
                      f"{_run(CONV, args)}", flush=True)
    for size in (48, 64):
        for cl in (1, 0):
            print(f"plain thin ResNet-18 {size}x{size} "
                  f"{'channels_last' if cl else 'nchw'} {t} threads: "
                  f"{_run(NET, (t, size, cl))}", flush=True)


if __name__ == "__main__":
    main()
