"""Time other builds of K5 and K6 against the checkout's, on one card.

    python3 -m stopthepop_tpu_torch.kernels.hier_probe NAME=DIR [NAME=DIR ...]
        [--out FILE]

Each DIR holds a ``hier_blend_fwd.cu``, a ``hier_blend_bwd.cu`` and the
``hier_common.cuh`` they include, with the C interfaces of
``csrc/hier_blend_fwd.cu`` and ``csrc/hier_blend_bwd.cu``: an earlier
version of the kernels (e.g. unpacked with ``git show``) or a step of a
redesign. The checkout's own ``csrc/`` joins as ``tree``, last. Every
variant is built with ``build.NVCC_FLAGS`` (all nvcc processes at once),
then run on the bench frame of ``chip_smoke.py`` (1920x1080, 500K
Gaussians from seed 0, queues (64, 8, 4)):

* K5's outputs against ``blend_hier_forward_plain`` (bitwise), K6's d_pair
  against ``blend_hier_backward_plain`` (largest error over each column's
  largest value; bitwise flag);
* times, CUDA events over 20 launches after 2, taken in turns: every
  variant in the given order, then in the reverse order (A B .. Z Z .. B A),
  and each variant's two times averaged.

Prints one JSON line a variant, the card's name and power limit, and writes
the lines to FILE when given. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import build
from . import hier_blend as hb

QUEUES = (64, 8, 4)
WIDTH, HEIGHT, GAUSSIANS = 1920, 1080, 500_000
ITERS = 20
_PTXAS = re.compile(r"Compiling entry function '\S*Li8ELi4E\S*'.*?(\d+) bytes spill "
                    r"stores.*?Used (\d+) registers", re.S)


def _build(variants):
    """{name: (K5 fn, K6 fn, {"fwd": (registers, spill stores), "bwd":
    ...} of the (8, 4) instantiation)}."""
    out_root = build.BUILD_DIR.parent / "hier_probe"
    procs = {}
    for name, src in variants.items():
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for part in ("fwd", "bwd"):
            so = out_dir / f"{part}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                   str(Path(src) / f"hier_blend_{part}.cu")]
            procs[name, part] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, part), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {part}:\n{log}")
        m = _PTXAS.search(log)
        fn = hb.bind(ctypes.CDLL(str(so)), backward=part == "bwd")
        fns, regs = libs.setdefault(name, ({}, {}))
        fns[part] = fn
        regs[part] = (int(m.group(2)), int(m.group(1))) if m else None
    return {n: (f["fwd"], f["bwd"], r) for n, (f, r) in libs.items()}


def _bench_frame(dev):
    from ..models.gaussians import init_random
    from ..render.duplicate import build_pairs
    from ..render.pipeline import tile_grid
    from ..render.preprocess import preprocess
    from ..utils.testing import make_camera

    model = init_random(GAUSSIANS, seed=0, extent=1.5, sh_degree=3, device=dev)
    with torch.no_grad():
        model.scales_log -= 2.3
    cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
    with torch.no_grad():
        prep = preprocess(
            model.means3d, model.opacities(), scales=model.scales(),
            rotations=model.rotations_normalized(), shs=model.shs(),
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            image_width=WIDTH, image_height=HEIGHT, sh_degree=3,
            rect_bounding=True, tight_opacity_bounding=True)
        gx, gy = tile_grid(WIDTH, HEIGHT)
        pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    args = (pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d.contiguous(),
            prep.conic_opacity.contiguous(), prep.rgb.contiguous(),
            prep.cov3d_inv9.contiguous(),
            prep.opacity_power_threshold.contiguous(),
            cam.inv_viewprojmatrix.contiguous(), cam.campos.contiguous())
    kw = dict(queue_sizes=QUEUES, hier_4x4_culling=False, grid_x=gx,
              grid_y=gy, width=WIDTH, height=HEIGHT)
    return args, kw


def _ms(fn):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hier_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = dict(v.split("=", 1) for v in opts.variants)
    variants["tree"] = str(build.CSRC)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    fns = _build(variants)
    dev = torch.device("cuda")
    args, kw = _bench_frame(dev)
    with torch.no_grad():
        ref = hb.blend_hier_forward_plain(*args, **kw)
        gen = torch.Generator(device=dev).manual_seed(7)
        cot = (torch.randn((3, HEIGHT, WIDTH), generator=gen, device=dev),
               torch.randn((HEIGHT, WIDTH), generator=gen, device=dev))
        bwd_args = (*args, ref[0], ref[1], ref[2], *cot)
        ref_d = hb.blend_hier_backward_plain(*bwd_args, **kw)
    scale = ref_d.abs().amax(dim=0)
    bind_fwd, bind_bwd = hb._bind, hb._bind_bwd
    rows, times = {}, {n: {"k5": [], "k6": []} for n in variants}
    order = list(variants) + list(reversed(variants))
    try:
        for name in variants:
            k5, k6, regs = fns[name]
            hb._bind, hb._bind_bwd = (lambda f=k5: f), (lambda f=k6: f)
            got = hb.blend_hier_forward(*args, **kw)
            d = hb.blend_hier_backward(*bwd_args, **kw)
            again = hb.blend_hier_backward(*bwd_args, **kw)
            torch.cuda.synchronize()
            rows[name] = {
                "variant": name, "source": variants[name],
                "registers_spill_stores_8_4": regs,
                "k5_bitwise": all(torch.equal(g, r) for g, r in zip(got, ref)),
                "k5_n_contrib_mismatches": int((got[2] != ref[2]).sum()),
                "k5_max_abs_err_color": float((got[0] - ref[0]).abs().max()),
                "k6_max_rel_err": float(((d - ref_d).abs().amax(dim=0)
                                         / scale.clamp(min=1e-30)).max()),
                "k6_bitwise_plain": bool(torch.equal(d, ref_d)),
                "k6_bitwise_repeat": bool(torch.equal(d, again)),
            }
        for name in order:
            k5, k6, _ = fns[name]
            hb._bind, hb._bind_bwd = (lambda f=k5: f), (lambda f=k6: f)
            times[name]["k5"].append(_ms(lambda: hb.blend_hier_forward(*args, **kw)))
            times[name]["k6"].append(_ms(lambda: hb.blend_hier_backward(*bwd_args, **kw)))
    finally:
        hb._bind, hb._bind_bwd = bind_fwd, bind_bwd
    lines = []
    for name in variants:
        t = times[name]
        rows[name].update({"k5_ms": t["k5"], "k6_ms": t["k6"],
                           "k5_ms_mean": sum(t["k5"]) / 2,
                           "k6_ms_mean": sum(t["k6"]) / 2, "card": card})
        lines.append(json.dumps(rows[name]))
        print(lines[-1], flush=True)
    print(card)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text("\n".join(lines) + "\n")
    ok = all(r["k5_bitwise"] and r["k6_max_rel_err"] <= 1e-4
             and r["k6_bitwise_repeat"] for r in rows.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
