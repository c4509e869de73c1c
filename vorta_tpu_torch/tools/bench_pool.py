"""The lowres expert's pooling, plain PyTorch against the CUDA kernels, at
Wan 720p (counterpart of tools/bench_pool.py).

Geometry: latent (20, 45, 80) = 72,000 tokens, lowres window (2, 3, 2)
(6,000 groups of 12 slots, 5 kept margins), 12 heads x 128, bf16.  Arms
(``--which``; the JAX tool's names in brackets):

  plain  [xla]     ops/coreset.py: Q's matching, q / k / v pooled by it, the
                   sum unpooled; the same for every stage, as in the JAX tool
  kernel [pallas]  by ``--stage``:
      both       pool_qkv + unpool (csrc/coreset_pool.cu), every head
      pool       pool_qkv alone
      copy       ``copy_probe``: the pool's cells with no matching (slot 0
                 as each group's center, slots 0..U-1 as its margins), the
                 pool's data-movement floor
      headmap5   pool_qkv + unpool in head-map mode over heads 0-4
      headmap12  the same over all 12 heads

Each iteration perturbs q (q * (1 + 0.001 i)) and reduces the outputs to a
mean, as the JAX tool does; the kernel arm's unpool takes the pool pass's
picks (the CUDA unpool needs them; the JAX tool's re-derives the matching
from q).  Times are CUDA events around 4 iterations after a
warm-up, printed as ms per iteration; with ``--device cpu`` (the plain
versions, at a ``--latent`` small enough for the CPU) the host's clock, a
check that the tool runs and not a measurement of the card.

  python -m vorta_tpu_torch.tools.bench_pool --stage headmap5
  python -m vorta_tpu_torch.tools.bench_pool --device cpu --latent 4 6 16 --stage copy
"""

from __future__ import annotations

import argparse
import ctypes
import time

import torch

from ..config import AttentionConfig
from ..device import resolve_device
from ..geometry import LowresGroups
from ..ops import _build
from ..ops.coreset import geometry_of, group_view, pool_by_similarity, unpool_by_similarity
from ..ops.coreset_pallas import pool_qkv, unpool
from ..ops.experts import lowres_groups_for

STAGES = ("both", "pool", "copy", "headmap5", "headmap12")
HEADS, ITERS = 12, 4  # Wan's heads; timed iterations after one warm-up, as the JAX tool


def copy_probe_ref(q, k, v, groups: LowresGroups):
    """Plain version of the copy probe: (pq, pk, pv), each (B, H, P, D) in the
    pooled layout, slot 0 of each group as its center and slots 0..U-1 as
    its margins."""
    u = groups.num_kept_margins
    out = []
    for x in (q, k, v):
        xg = group_view(x, groups)  # (B, H, G, gs, D)
        b, h, g, _, d = xg.shape
        out.append(torch.cat([xg[:, :, :, 0], xg[:, :, :, :u].reshape(b, h, g * u, d)], dim=2))
    return tuple(out)


def copy_probe(q, k, v, groups: LowresGroups):
    """The copy probe: ``csrc/coreset_pool.cu``'s copy kernel on CUDA tensors
    (bf16, D 64 or 128), the plain version on CPU tensors."""
    if k.shape != q.shape or v.shape != q.shape or q.shape[2] != groups.full_length:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} for "
                         f"{groups.full_length} tokens")
    if q.device.type == "cpu":
        return copy_probe_ref(q, k, v, groups)
    _build.forward_only("copy_probe", q, k, v)
    dev = _build.require_cuda(q, k, v)
    b, h, _, d = q.shape
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)) or d not in (64, 128) \
            or groups.group_size > 32:
        raise NotImplementedError(f"the CUDA copy probe takes bf16 (f32: ROADMAP section 2 A7, "
                                  f"the tools' kernels in f32), D 64/128 and at most 32 slots "
                                  f"per group, got {q.dtype}, D={d}, {groups.group_size}")
    geom = geometry_of(groups)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = [torch.empty((b, h, groups.pooled_length, d), dtype=q.dtype, device=dev)
           for _ in range(3)]
    fn = _build.load("coreset_pool").vorta_copy_probe_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *(o.data_ptr() for o in out), b, h,
             *geom.latent_shape, d, *geom.window, groups.num_kept_margins,
             _build.stream_ptr(dev))
    _build.check(err, "copy_probe")
    _build.launches["copy_probe"] += 1
    return tuple(out)


def _mean(*xs) -> torch.Tensor:
    return sum(x.float().mean() for x in xs)


def stage_fn(stage: str, which: str, groups: LowresGroups, q, k, v):
    """One iteration of an arm: fn(i) -> a scalar tensor."""
    h = q.shape[1]

    def perturbed(i):
        return q * (1 + 0.001 * i)

    if which == "plain":
        def plain(i):
            pq, m = pool_by_similarity(perturbed(i), groups)
            pk, _ = pool_by_similarity(k, groups, m)
            pv, _ = pool_by_similarity(v, groups, m)
            return _mean(unpool_by_similarity(pq + pk + pv, groups, m))
        return plain
    if stage == "copy":
        return lambda i: _mean(*copy_probe(perturbed(i), k, v, groups))
    if stage == "pool":
        return lambda i: _mean(*pool_qkv(perturbed(i), k, v, groups))
    if stage == "both":
        def both(i):
            qq = perturbed(i)
            pq, pk, pv, picks = pool_qkv(qq, k, v, groups, return_picks=True)
            return _mean(unpool(pq + pk + pv, qq, groups, picks=picks))
        return both
    n = int(stage[len("headmap"):])
    head_map = torch.minimum(torch.arange(h), torch.tensor(n - 1)).to(torch.int32).to(q.device)
    routed = (torch.arange(h, device=q.device) < n)[None, :, None, None]

    def headmap(i):
        qq = perturbed(i)
        kw = dict(head_map=head_map, num_active=n)
        pq, pk, pv, picks = pool_qkv(qq, k, v, groups, return_picks=True, **kw)
        up = unpool(pq + pk + pv, qq, groups, picks=picks, **kw)
        return _mean(torch.where(routed, up, torch.zeros((), dtype=up.dtype, device=up.device)))
    return headmap


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """ms per iteration: CUDA events on the card, the host clock on the CPU."""
    float(fn(0))  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        acc = sum(fn(i + 1) for i in range(iters))
        end.record()
        torch.cuda.synchronize(dev)
        float(acc)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    float(sum(fn(i + 1) for i in range(iters)))
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="both", choices=["both", "plain", "kernel"])
    ap.add_argument("--stage", default="both", choices=STAGES)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--latent", type=int, nargs=3, default=(20, 45, 80),
                    help="latent grid (T, H, W); the default is Wan 720p x 77f")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    attn = AttentionConfig(latent_shape=tuple(args.latent), sta_window=(3, 3, 3),
                           sta_tile=(5, 9, 8), lowres_window=(2, 3, 2),
                           block_q=1024, block_kv=1024)
    groups = lowres_groups_for(attn)
    g = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q, k, v = (torch.randn((1, HEADS, attn.seq_len, 128), generator=g, device=dev).to(dtype)
               for _ in range(3))
    times = {}
    with torch.inference_mode():
        for which in ("plain", "kernel"):
            if args.which in ("both", which):
                times[which] = time_ms(stage_fn(args.stage, which, groups, q, k, v), ITERS, dev)
                print(f"{which:8s} {times[which]:8.2f} ms", flush=True)
    return times


if __name__ == "__main__":
    main()
