"""Time other builds of a family of kernels against the checkout's, on one card.

    python3 -m stopthepop_tpu_torch.kernels.hier_probe NAME=DIR [NAME=DIR ...]
        [--family hier|kbuffer|full|global] [--batched] [--out FILE]

A family is the kernels of one sort mode whose sources a redesign touches:

* ``hier`` (the default): K5 and K6. Each DIR holds a ``hier_blend_fwd.cu``,
  a ``hier_blend_bwd.cu`` and the headers they include (``hier_common.cuh``,
  ``route_common.cuh``), with the C interfaces of the checkout's. With
  ``--batched`` both run the batched cascade, built from
  ``hier_blend_{fwd,bwd}_batched.cu`` (every DIR needs them).
* ``kbuffer``: K3 and K4 at k = 4, from ``kbuffer_blend_fwd.cu``,
  ``kbuffer_blend_bwd.cu`` and the headers they include; K4's input is the
  plain K3's output.
* ``full``: K7, from ``full_blend_fwd.cu``; its list length (``kList``, or
  ``K`` of the register window before it) is read from the source. A
  source from before the pass counter (no ``passes`` in its C entry point)
  is called without the counter, which it leaves as it is.
* ``global``: K1 and K2, from ``global_blend_fwd.cu``,
  ``global_blend_bwd.cu`` and the headers they include; K2's input is the
  plain K1's output. A source from before the piece table (its C entry
  points take grid_x and grid_y) is called with the bench frame's grid.

A DIR holds an earlier version of the sources (e.g. unpacked with ``git
show``) or a step of a redesign. A backward source from before the
binning tile's sub-tile planes (no ``sub_tile`` in it) has an interface
without them: the probe calls it with one plane, as the checkout's is
called at 16x16 bins, so its bits can be held against the checkout's. The checkout's own ``csrc/`` joins as
``tree``, last. Every variant is built with ``build.NVCC_FLAGS`` (all nvcc
processes at once), then run on the bench frame of ``chip_smoke.py``
(1920x1080, 500K Gaussians from seed 0; queues (64, 8, 4) for ``hier``):

* each kernel's outputs against its plain version: K1's, K3's, K5's and
  K7's bitwise, K2's, K4's and K6's d_pair as the largest error over each
  column's largest value, a bitwise flag and a flag that two launches give
  the same bits; for K7 also the passes ("rounds") a tile takes at the
  variant's list length, from the plain version's counts; for ``kbuffer``
  and ``global`` also a flag that the outputs have the bits of the first
  variant's (the parent's sources, where given first), for ``hier`` the
  same flag, and first of all (``kbuffer``, ``global``) a line of the plain
  version's counts under each warp shape of ``kernels/footprint.py``;
* times, CUDA events over 20 launches after 2, taken in turns: every
  variant in the given order, then in the reverse order (A B .. Z Z .. B A),
  and each variant's two times averaged;
* registers and spill stores (ptxas; K5/K6 at (8, 4), K3/K4 at MAX_K = 4),
  and where the source exports its occupancy query, blocks an SM and
  shared bytes a block.

Prints one JSON line a variant, the card's name and power limit, and writes
the lines to FILE when given. Exits 1 if a variant disagrees with the plain
version (a diagnostic build that skips work does). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import build
from . import footprint
from . import full_blend as fb
from . import global_blend as gb
from . import hier_blend as hb
from . import kbuffer_blend as kb

QUEUES = (64, 8, 4)
KB_K = 4
WIDTH, HEIGHT, GAUSSIANS = 1920, 1080, 500_000
ITERS = 20
# The instantiation whose registers a family reports ("hier_batched": the
# batched cascade's K5/K6).
_ENTRY = {"hier": r"\S*Li8ELi4E(?!Lb1E)\S*", "kbuffer": r"\S*ILi4EE\S*",
          "hier_batched": r"\S*Li8ELi4ELb1E\S*",
          "full": r"\S*full_blend_fwd_kernel\S*",
          "global": r"\S*global_blend_(?:fwd|bwd)_kernel(?!ILb1E)\S*"}
_SOURCES = {"hier": ("hier_blend_fwd", "hier_blend_bwd"),
            "hier_batched": ("hier_blend_fwd_batched",
                             "hier_blend_bwd_batched"),
            "kbuffer": ("kbuffer_blend_fwd", "kbuffer_blend_bwd"),
            "full": ("full_blend_fwd",),
            "global": ("global_blend_fwd", "global_blend_bwd")}
_LIST = re.compile(r"constexpr int (?:kList|K) = (\d+);")


def _ptxas(family, log):
    m = re.search(rf"Compiling entry function '{_ENTRY[family]}'.*?(\d+) bytes "
                  r"spill stores.*?Used (\d+) registers", log, re.S)
    return (int(m.group(2)), int(m.group(1))) if m else None


def _build(family, variants):
    """{name: ({source stem: loaded library}, {source stem: (registers,
    spill stores)})}."""
    out_root = build.BUILD_DIR.parent / f"{family}_probe"
    procs = {}
    for name, src in variants.items():
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for stem in _SOURCES[family]:
            so = out_dir / f"{stem}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                   str(Path(src) / f"{stem}.cu")]
            procs[name, stem] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, stem), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {stem}:\n{log}")
        found, regs = libs.setdefault(name, ({}, {}))
        found[stem] = ctypes.CDLL(str(so))
        text = (Path(variants[name]) / f"{stem}.cu").read_text()
        found[stem]._stp_one_plane = (stem.endswith("_bwd")
                                      and "sub_tile" not in text)
        entry = re.search(rf'int stp_{stem}\(([^)]*)\)', text)
        found[stem]._stp_grid = (family == "global" and entry is not None
                                 and "pieces" not in entry.group(1))
        found[stem]._stp_no_passes = (family == "full" and entry is not None
                                      and "passes" not in entry.group(1))
        regs[stem] = _ptxas(family, log)
    return libs


def _bwd(fn, lib, tail):
    """A backward entry point ``fn`` of ``lib``, typed for the checkout's
    interface. A build from before the sub-tile planes takes no
    (sub_tile, num_pairs), the two arguments ``tail`` before the last: it
    is typed without them and called with one plane only."""
    if not getattr(lib, "_stp_one_plane", False):
        return fn
    types = list(fn.argtypes)
    cut = len(types) - tail - 2
    fn.argtypes = types[:cut] + types[cut + 2:]

    def one_plane(*args):
        if args[cut] is not None:
            raise ValueError("a build from before the sub-tile planes "
                             "serves one plane only")
        return fn(*args[:cut], *args[cut + 2:])
    return one_plane


def _bench_frame(dev):
    """The bench frame's K5 inputs (K3's with the culling thresholds at
    index 7), keywords and depths (K1's last input)."""
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
    kw = dict(grid_x=gx, grid_y=gy, width=WIDTH, height=HEIGHT)
    return args, kw, prep.depth.contiguous()


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


def _cotangents(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return (torch.randn((3, HEIGHT, WIDTH), generator=gen, device=dev),
            torch.randn((HEIGHT, WIDTH), generator=gen, device=dev))


def _grad_checks(prefix, got, again, ref):
    scale = ref.abs().amax(dim=0)
    return {f"{prefix}_max_rel_err": float(((got - ref).abs().amax(dim=0)
                                            / scale.clamp(min=1e-30)).max()),
            f"{prefix}_bitwise_plain": bool(torch.equal(got, ref)),
            f"{prefix}_bitwise_repeat": bool(torch.equal(got, again))}


class _SameAsFirst:
    """Whether a variant's outputs have the bits of the first variant's."""

    def same_as_first(self, outputs, key=""):
        """``key`` tells apart the outputs of the family's kernels."""
        outputs = [o.clone() for o in outputs]
        if not hasattr(self, "first"):
            self.first = {}
        first = self.first.setdefault(key, outputs)
        return all(torch.equal(a, b) for a, b in zip(outputs, first))


class _Hier(_SameAsFirst):
    """K5 and K6 (the probe's first family; its keys are unchanged), with
    the batched cascade where ``batched``."""
    module, timed = hb, ("k5", "k6")

    def __init__(self, dev, batched=False):
        args, kw, _ = _bench_frame(dev)
        self.batched = batched
        self.args, self.kw = args, {**kw, "queue_sizes": QUEUES,
                                    "hier_4x4_culling": False,
                                    "batched_cascade": batched}
        with torch.no_grad():
            self.ref = hb.blend_hier_forward_plain(*self.args, **self.kw)
            self.bwd_args = (*self.args, *self.ref[:3], *_cotangents(dev))
            self.ref_d = hb.blend_hier_backward_plain(*self.bwd_args, **self.kw)

    def bind(self, libs):
        b = self.batched
        hb._bind = lambda batched=False, f=hb.bind(
            libs[hb.library(hb.KERNEL, b)], batched=b): f
        lib = libs[hb.library(hb.BWD_KERNEL, b)]
        hb._bind_bwd = (lambda batched=False, f=_bwd(
            hb.bind(lib, backward=True, batched=b), lib, 3): f)

    def run(self):
        return {"k5": lambda: hb.blend_hier_forward(*self.args, **self.kw),
                "k6": lambda: hb.blend_hier_backward(*self.bwd_args, **self.kw)}

    def check(self, libs, regs, source):
        got = hb.blend_hier_forward(*self.args, **self.kw)
        d = hb.blend_hier_backward(*self.bwd_args, **self.kw)
        again = hb.blend_hier_backward(*self.bwd_args, **self.kw)
        torch.cuda.synchronize()
        return {
            "registers_spill_stores_8_4": {
                "fwd": regs[hb.library(hb.KERNEL, self.batched)],
                "bwd": regs[hb.library(hb.BWD_KERNEL, self.batched)]},
            "k5_bitwise": all(torch.equal(g, r) for g, r in zip(got, self.ref)),
            "k5_n_contrib_mismatches": int((got[2] != self.ref[2]).sum()),
            "k5_max_abs_err_color": float((got[0] - self.ref[0]).abs().max()),
            "k5_k6_bitwise_first": self.same_as_first([*got, d]),
            **_grad_checks("k6", d, again, self.ref_d)}

    @staticmethod
    def ok(row):
        return (row["k5_bitwise"] and row["k6_max_rel_err"] <= 1e-4
                and row["k6_bitwise_repeat"])


def _footprint_counts(module, plain):
    """{shape: the plain version's counts} under each warp shape of
    ``kernels/footprint.py``; ``plain()`` runs the plain version with
    ``count_evaluations`` and returns its counts."""
    saved = module.WARP_SHAPE
    out = {}
    try:
        for shape in footprint.SHAPES:
            module.WARP_SHAPE = shape
            with torch.no_grad():
                out[f"{shape[0]}x{shape[1]}"] = plain()
    finally:
        module.WARP_SHAPE = saved
    return out


class _KBuffer(_SameAsFirst):
    """K3 and K4 at k = 4; K4 on the plain K3's output."""
    module, timed = kb, ("k3", "k4")

    def __init__(self, dev):
        args, kw, _ = _bench_frame(dev)
        self.args = args[:7] + args[8:]
        self.kw = {**kw, "k": KB_K}
        with torch.no_grad():
            self.ref = kb.blend_kbuffer_forward_plain(*self.args, **self.kw)
            self.bwd_args = (*self.args, *self.ref[:3], *_cotangents(dev))
            self.ref_d = kb.blend_kbuffer_backward_plain(*self.bwd_args,
                                                         **self.kw)
        self.counts = _footprint_counts(kb, lambda: kb.blend_kbuffer_forward_plain(
            *self.args, **self.kw, count_evaluations=True)[4])

    def bind(self, libs):
        kb._bind = lambda f=kb.bind(libs["kbuffer_blend_fwd"]): f
        lib = libs["kbuffer_blend_bwd"]
        kb._bind_bwd = lambda f=_bwd(kb.bind(lib, backward=True), lib, 3): f

    def run(self):
        return {"k3": lambda: kb.blend_kbuffer_forward(*self.args, **self.kw),
                "k4": lambda: kb.blend_kbuffer_backward(*self.bwd_args,
                                                        **self.kw)}

    def check(self, libs, regs, source):
        got = kb.blend_kbuffer_forward(*self.args, **self.kw)
        d = kb.blend_kbuffer_backward(*self.bwd_args, **self.kw)
        again = kb.blend_kbuffer_backward(*self.bwd_args, **self.kw)
        torch.cuda.synchronize()
        occ = {}
        for stem, query in (("kbuffer_blend_fwd", kb.occupancy_fwd),
                            ("kbuffer_blend_bwd", kb.occupancy_bwd)):
            lib = libs[stem]
            occ[stem] = (query(KB_K, lib)
                         if hasattr(lib, f"stp_{stem}_occupancy") else None)
        return {"registers_spill_stores_max_k_4": {
                    "k3": regs["kbuffer_blend_fwd"],
                    "k4": regs["kbuffer_blend_bwd"]},
                "occupancy_max_k_4": {"k3": occ["kbuffer_blend_fwd"],
                                      "k4": occ["kbuffer_blend_bwd"]},
                "k3_bitwise": all(torch.equal(g, r)
                                  for g, r in zip(got, self.ref)),
                "k3_n_contrib_mismatches": int((got[2] != self.ref[2]).sum()),
                "k3_max_abs_err_color": float((got[0] - self.ref[0]).abs().max()),
                "k3_k4_bitwise_first": self.same_as_first([*got, d]),
                **_grad_checks("k4", d, again, self.ref_d)}

    @staticmethod
    def ok(row):
        return (row["k3_bitwise"] and row["k4_bitwise_plain"]
                and row["k4_bitwise_repeat"])


class _Global(_SameAsFirst):
    """K1, and K2 on the plain K1's output."""
    module, timed = gb, ("k1", "k2")

    def __init__(self, dev):
        args, self.kw, depth = _bench_frame(dev)
        self.args = (*args[:6], depth)
        with torch.no_grad():
            self.ref = gb.blend_global_forward_plain(*self.args, **self.kw)
            self.bwd_args = (*args[:6], *self.ref[:3], *_cotangents(dev))
            self.ref_d = gb.blend_global_backward_plain(*self.bwd_args,
                                                        **self.kw)
        self.counts = _footprint_counts(gb, self._plain_counts)

    def _plain_counts(self):
        fwd, bwd = {}, {}
        *_, evaluations, blends = gb.blend_global_forward_plain(
            *self.args, **self.kw, count_evaluations=True, warp_counts=fwd)
        _, bwd_evaluations, bwd_blends = gb.blend_global_backward_plain(
            *self.bwd_args, **self.kw, count_evaluations=True,
            warp_counts=bwd)
        return {"k1": {"evaluations": evaluations, "blends": blends, **fwd},
                "k2": {"evaluations": bwd_evaluations, "blends": bwd_blends,
                       **bwd}}

    def bind(self, libs):
        gb._bind = lambda f=self._entry(libs["global_blend_fwd"], gb.bind,
                                        7): f
        gb._bind_bwd = lambda f=self._entry(libs["global_blend_bwd"],
                                            gb.bind_bwd, 11): f

    def _entry(self, lib, bind, at):
        """K1's or K2's entry point in ``lib``, called with the checkout's
        arguments. A build from before the piece table takes (grid_x,
        grid_y) where the checkout's takes the table and its count, at
        argument ``at``: it is typed so and called with the bench frame's
        grid there."""
        fn = bind(lib)
        if lib._stp_grid:
            fn.argtypes = [*fn.argtypes[:at], ctypes.c_int,
                           *fn.argtypes[at + 1:]]
        fn = _bwd(fn, lib, 2)
        if not lib._stp_grid:
            return fn
        grid = (self.kw["grid_x"], self.kw["grid_y"])
        return lambda *args: fn(*args[:at], *grid, *args[at + 2:])

    def run(self):
        return {"k1": lambda: gb.blend_global_forward(*self.args, **self.kw),
                "k2": lambda: gb.blend_global_backward(*self.bwd_args,
                                                       **self.kw)}

    def check(self, libs, regs, source):
        got = gb.blend_global_forward(*self.args, **self.kw)
        d = gb.blend_global_backward(*self.bwd_args, **self.kw)
        again = gb.blend_global_backward(*self.bwd_args, **self.kw)
        torch.cuda.synchronize()
        occ = {}
        for key, stem, query in (("k1", "global_blend_fwd", gb.occupancy_fwd),
                                 ("k2", "global_blend_bwd", gb.occupancy_bwd)):
            lib = libs[stem]
            occ[key] = (query(lib) if hasattr(lib, f"stp_{stem}_occupancy")
                        else None)
        return {"registers_spill_stores": {"k1": regs["global_blend_fwd"],
                                           "k2": regs["global_blend_bwd"]},
                "occupancy": occ,
                "k1_bitwise": all(torch.equal(g, r)
                                  for g, r in zip(got, self.ref)),
                "k1_n_contrib_mismatches": int((got[2] != self.ref[2]).sum()),
                "k1_max_abs_err_color": float((got[0] - self.ref[0]).abs().max()),
                "k1_bitwise_first": self.same_as_first(got, "k1"),
                "k2_bitwise_first": self.same_as_first([d], "k2"),
                **_grad_checks("k2", d, again, self.ref_d)}

    @staticmethod
    def ok(row):
        return (row["k1_bitwise"] and row["k2_max_rel_err"] <= 1e-4
                and row["k2_bitwise_repeat"])


def _without_counter(fn, *args):
    """K7's entry point ``fn`` from a build without the pass counter,
    called with the checkout's arguments: all but the counter, the
    argument before the stream."""
    return fn(*args[:-2], args[-1])


class _Full:
    """K7, with its passes a tile at the variant's list length."""
    module, timed = fb, ("k7",)

    def __init__(self, dev):
        args, self.kw, _ = _bench_frame(dev)
        self.args = args[:7] + args[8:]
        with torch.no_grad():
            self.ref = fb.blend_full_forward_plain(*self.args, **self.kw)
        self.rounds = {}

    def rounds_at(self, length):
        if length not in self.rounds:
            window = fb.WINDOW
            try:
                fb.WINDOW = length
                with torch.no_grad():
                    n = fb.blend_full_forward_plain(*self.args, **self.kw,
                                                    count_evaluations=True)[4]
            finally:
                fb.WINDOW = window
            self.rounds[length] = n["rounds"]
        return self.rounds[length]

    def bind(self, libs):
        lib = libs["full_blend_fwd"]
        fn = fb.bind(lib)
        if lib._stp_no_passes:
            # A build from before the pass counter takes no counter before
            # the stream: typed so and called without it.
            fn.argtypes = [*fn.argtypes[:-2], fn.argtypes[-1]]
            fn = functools.partial(_without_counter, fn)
        fb._bind = lambda f=fn: f

    def run(self):
        return {"k7": lambda: fb.blend_full_forward(*self.args, **self.kw)}

    def check(self, libs, regs, source):
        got = fb.blend_full_forward(*self.args, **self.kw)
        torch.cuda.synchronize()
        lib = libs["full_blend_fwd"]
        occ = (fb.occupancy(lib)
               if hasattr(lib, "stp_full_blend_fwd_occupancy") else None)
        m = _LIST.search((Path(source) / "full_blend_fwd.cu").read_text())
        length = int(m.group(1)) if m else None
        return {"registers_spill_stores": regs["full_blend_fwd"],
                "occupancy": occ, "list": length,
                "rounds": self.rounds_at(length) if length else None,
                "k7_bitwise": all(torch.equal(g, r)
                                  for g, r in zip(got, self.ref)),
                "k7_n_contrib_mismatches": int((got[2] != self.ref[2]).sum()),
                "k7_max_abs_err_color": float((got[0] - self.ref[0]).abs().max())}

    @staticmethod
    def ok(row):
        return row["k7_bitwise"]


FAMILIES = {"hier": _Hier, "kbuffer": _KBuffer, "full": _Full,
            "global": _Global}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--family", choices=sorted(FAMILIES), default="hier")
    ap.add_argument("--out")
    ap.add_argument("--batched", action="store_true",
                    help="hier: K5 and K6 with the batched cascade (every "
                         "variant must have its entry points)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hier_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = dict(v.split("=", 1) for v in opts.variants)
    variants["tree"] = str(build.CSRC)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    batched = opts.batched and opts.family == "hier"
    libs = _build("hier_batched" if batched else opts.family, variants)
    fam = (_Hier(torch.device("cuda"), batched=True) if batched
           else FAMILIES[opts.family](torch.device("cuda")))
    mod = fam.module
    saved = {n: getattr(mod, n) for n in ("_bind", "_bind_bwd")
             if hasattr(mod, n)}
    rows = {}
    lines = []
    if getattr(fam, "counts", None) is not None:
        lines.append(json.dumps({"plain_counts": fam.counts, "card": card}))
        print(lines[-1], flush=True)
    times = {n: {k: [] for k in fam.timed} for n in variants}
    order = list(variants) + list(reversed(variants))
    try:
        for name in variants:
            found, regs = libs[name]
            fam.bind(found)
            rows[name] = {"variant": name, "source": variants[name],
                          **fam.check(found, regs, variants[name])}
        for name in order:
            fam.bind(libs[name][0])
            for key, fn in fam.run().items():
                times[name][key].append(_ms(fn))
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)
    for name in variants:
        for key, t in times[name].items():
            rows[name].update({f"{key}_ms": t, f"{key}_ms_mean": sum(t) / 2})
        rows[name]["card"] = card
        lines.append(json.dumps(rows[name]))
        print(lines[-1], flush=True)
    print(card)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text("\n".join(lines) + "\n")
    return 0 if all(fam.ok(r) for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
