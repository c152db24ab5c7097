"""Per-layer conv breakdown of the CelebA-128 train step (the counterpart
of ``scripts/conv_breakdown.py``):

    python -m ladder_tpu_torch.conv_breakdown [--batch 64] [--hidden 512]
        [--dtype bfloat16|float32] [--device cuda|cpu]

Times every conv shape of the production model (the JAX script's 14, in
NCHW / OIHW, with TF's SAME and VALID padding as ``models/layers.py:Conv``
pads them) three ways: the forward, the gradient to the input and the
gradient to the weight, each alone (``aten.convolution_backward`` with one
output asked for, as XLA drops the unused half of a vjp); then the five
TF1 resizes through ``ops/image.py``, the 8 x dense dlatent MLP and three
matmul reference points. Prints the JAX script's table, with achieved
TF/s per op; ``main`` returns the conv rows.

The inputs are drawn on the device from a seeded generator (the JAX
script draws them on the host; a time does not depend on them). On the
card each time is CUDA events around ``iters`` calls after ``warmup``
calls; float32 runs under the train step's precision policy
(``utils/device.py:float32_exact``, TF32 off), so the table shows what the
step pays. ``--device cpu`` times on the host clock (for tests; no device
number).
"""

from __future__ import annotations

import argparse
import contextlib
import time


def conv_shapes(H):
    """(name, H=W, Cin, Cout, k, stride, padding) of the model's convs."""
    return [
        ("enc1 128->64", 128, 3, H // 4, 3, 2, "SAME"),
        ("enc2 64->32", 64, H // 4, H // 4, 3, 2, "SAME"),
        ("enc3 32->16", 32, H // 4, H // 2, 3, 2, "SAME"),
        ("enc4 16->8", 16, H // 2, H // 2, 3, 2, "SAME"),
        ("enc5 8->4", 8, H // 2, H, 3, 2, "SAME"),
        ("enc6 4->2 valid", 4, H, H, 3, 1, "VALID"),
        ("dec 2x2 a", 2, H, H, 3, 1, "SAME"),
        ("dec 2x2 b", 2, H, H, 3, 1, "SAME"),
        ("dec 8x8", 8, H, H, 3, 1, "SAME"),
        ("dec 16x16", 16, H, H // 2, 3, 1, "SAME"),
        ("dec 32x32", 32, H // 2, H // 2, 3, 1, "SAME"),
        ("dec 64x64", 64, H // 2, H // 4, 3, 1, "SAME"),
        ("dec 128x128", 128, H // 4, H // 4, 3, 1, "SAME"),
        ("dec 1x1 out", 128, H // 4, 3, 1, 1, "SAME"),
    ]


def conv_flops(B, hw, cout, k, cin, stride, pad):
    oh = hw // stride if pad == "SAME" else hw - k + 1
    return 2 * B * oh * oh * cout * k * k * cin


def conv_fns(hw, k, stride, pad):
    """(fwd(x, w), dgrad(x, w, cot), wgrad(x, w, cot)) of one conv shape.
    TF's uneven SAME pads (stride 2 on an even size) are applied to x
    first, as the model does; the gradient to x drops them again."""
    import torch
    import torch.nn.functional as F

    from ladder_tpu_torch.models.layers import _same_pads

    p0, p1 = _same_pads(hw, k, stride) if pad == "SAME" else (0, 0)
    even = p0 == p1
    padding = [p0, p0] if even else [0, 0]

    def padded(x):
        return x if even else F.pad(x, (p0, p1, p0, p1))

    def fwd(x, w):
        return F.conv2d(padded(x), w, stride=stride, padding=padding)

    def backward(x, w, cot, mask):
        return torch.ops.aten.convolution_backward(
            cot, padded(x), w, None, [stride, stride], padding, [1, 1],
            False, [0, 0], 1, mask)

    def dgrad(x, w, cot):
        gx = backward(x, w, cot, [True, False, False])[0]
        return gx if even else gx[:, :, p0:p0 + hw, p0:p0 + hw]

    def wgrad(x, w, cot):
        return backward(x, w, cot, [False, True, False])[1]

    return fwd, dgrad, wgrad


def timeit(fn, *args, iters=20, warmup=3, device="cuda"):
    """Seconds a call: CUDA events around ``iters`` calls after ``warmup``
    on the card, the host clock on the CPU."""
    import torch

    for _ in range(warmup):
        fn(*args)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ladder_tpu_torch.ops.image import resize_bilinear_tf1
    from ladder_tpu_torch.utils.device import float32_exact, resolve_device

    device = resolve_device(args.device)
    B, H = args.batch, args.hidden
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    exact = float32_exact() if dt == torch.float32 \
        else contextlib.nullcontext()
    on_card = device.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(device) if on_card else device}",
          flush=True)

    gen = torch.Generator(device=device).manual_seed(0)

    def tensor(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dt)

    def timed(fn, *a):
        return timeit(fn, *a, device=device)

    rows = []
    total = dict(fwd=0.0, dgrad=0.0, wgrad=0.0)
    with exact, torch.no_grad():
        for name, hw, cin, cout, k, stride, pad in conv_shapes(H):
            x = tensor(B, cin, hw, hw)
            w = tensor(cout, cin, k, k, scale=0.05)
            fwd, dgrad, wgrad = conv_fns(hw, k, stride, pad)
            y = fwd(x, w)
            cot = tensor(*y.shape)
            t_f = timed(fwd, x, w)
            t_d = timed(dgrad, x, w, cot)
            t_w = timed(wgrad, x, w, cot)
            fl = conv_flops(B, hw, cout, k, cin, stride, pad)
            rows.append((name, f"{hw}x{hw}", cin, cout, fl / 1e9,
                         t_f * 1e3, fl / t_f / 1e12,
                         t_d * 1e3, fl / t_d / 1e12,
                         t_w * 1e3, fl / t_w / 1e12))
            total["fwd"] += t_f
            total["dgrad"] += t_d
            total["wgrad"] += t_w

        print(f"\nbatch={B} h={H} dtype={args.dtype}")
        print(f"{'layer':<16}{'hw':>8}{'cin':>5}{'cout':>5}{'GF':>8}"
              f"{'fwd ms':>8}{'TF/s':>7}{'dgrad ms':>9}{'TF/s':>7}"
              f"{'wgrad ms':>9}{'TF/s':>7}")
        for r in rows:
            print(f"{r[0]:<16}{r[1]:>8}{r[2]:>5}{r[3]:>5}{r[4]:>8.2f}"
                  f"{r[5]:>8.2f}{r[6]:>7.1f}{r[7]:>9.2f}{r[8]:>7.1f}"
                  f"{r[9]:>9.2f}{r[10]:>7.1f}")
        print(f"\nconv totals: fwd {total['fwd']*1e3:.2f} ms, "
              f"dgrad {total['dgrad']*1e3:.2f} ms, "
              f"wgrad {total['wgrad']*1e3:.2f} ms, "
              f"sum {(total['fwd']+total['dgrad']+total['wgrad'])*1e3:.2f} ms")

        for name, hw_in, hw_out, c in [
                ("resize 4->8", 4, 8, H), ("resize 8->16", 8, 16, H),
                ("resize 16->32", 16, 32, H // 2),
                ("resize 32->64", 32, 64, H // 2),
                ("resize 64->128", 64, 128, H // 4)]:
            x = tensor(B, c, hw_in, hw_in)
            t = timed(lambda x, o=hw_out: resize_bilinear_tf1(x, o, o), x)
            print(f"{name:<16} c={c:<4} {t*1e3:7.3f} ms")

        # dlatent MLP (8x dense 512)
        x = tensor(B, H)
        ws = [tensor(H, H, scale=0.05) for _ in range(8)]

        def mlp(x, ws):
            for w in ws:
                x = torch.nn.functional.leaky_relu(x @ w, 0.2)
            return x

        t = timed(mlp, x, ws)
        print(f"{'dlatent mlp x8':<16} {t*1e3:7.3f} ms")

        # matmul peak reference point
        for m, k2, n in [(16384, 1152, 128), (8192, 2048, 2048),
                         (65536, 128, 128)]:
            a = tensor(m, k2)
            b = tensor(k2, n)
            t = timed(torch.matmul, a, b)
            print(f"matmul {m}x{k2}x{n}: {t*1e3:7.3f} ms "
                  f"{2*m*k2*n/t/1e12:6.1f} TF/s")
    return rows


if __name__ == "__main__":
    main()
