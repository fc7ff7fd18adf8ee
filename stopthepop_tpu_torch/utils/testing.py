"""Synthetic scenes and cameras for tests and benchmarks (numpy-drawn).

Port of ``stopthepop_tpu/utils/testing.py``. Camera matrices follow the
torch-3DGS convention (transposed world-to-view / world-to-clip). Scenes are
drawn with numpy from a seed, so the same arrays can be handed to both
packages. ``run_ranks`` runs a test body in a group of CPU processes, for
the multi-device layer (``parallel/``). ``filtered_png`` writes PNG files
whose rows carry every filter type, as captures written with libpng's
adaptive filters do, for the native codec (``io/images.py``).
"""

from __future__ import annotations

import math
import os
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device


class Camera(NamedTuple):
    viewmatrix: torch.Tensor          # [4, 4] transposed world-to-view
    projmatrix: torch.Tensor          # [4, 4] transposed world-to-clip (full)
    inv_viewprojmatrix: torch.Tensor  # [4, 4]
    campos: torch.Tensor              # [3]
    tanfovx: float
    tanfovy: float
    width: int
    height: int


def make_camera(
    width: int,
    height: int,
    fovx_deg: float = 60.0,
    campos=(0.0, 0.0, -4.0),
    znear: float = 0.01,
    zfar: float = 100.0,
    device=None,
) -> Camera:
    """Axis-aligned camera at ``campos`` looking along +z (identity rotation)."""
    dev = resolve_device(device)
    tanfovx = math.tan(math.radians(fovx_deg) / 2.0)
    tanfovy = tanfovx * height / width
    c = np.asarray(campos, dtype=np.float32)

    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, 3] = -c

    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 1.0 / tanfovx
    proj[1, 1] = 1.0 / tanfovy
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0

    full = proj @ w2v

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    return Camera(
        viewmatrix=t(w2v.T),
        projmatrix=t(full.T),
        inv_viewprojmatrix=t(np.linalg.inv(full).T),
        campos=t(c),
        tanfovx=tanfovx,
        tanfovy=tanfovy,
        width=width,
        height=height,
    )


class Scene(NamedTuple):
    means3d: torch.Tensor    # [P, 3]
    scales: torch.Tensor     # [P, 3]
    rotations: torch.Tensor  # [P, 4] normalized (r, x, y, z)
    opacities: torch.Tensor  # [P]
    shs: torch.Tensor        # [P, 16, 3]
    colors: torch.Tensor     # [P, 3] precomputed alternative


def random_scene(seed: int, num_gaussians: int, extent: float = 1.5,
                 scale_range=(0.01, 0.12), device=None) -> Scene:
    """Random scene with the JAX package's distributions, drawn with numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = num_gaussians
    means = rng.uniform(-extent, extent, (n, 3))
    scales = np.exp(rng.uniform(math.log(scale_range[0]),
                                math.log(scale_range[1]), (n, 3)))
    q = rng.standard_normal((n, 4))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, (n,))
    shs = 0.3 * rng.standard_normal((n, 16, 3))
    colors = rng.uniform(0.0, 1.0, (n, 3))
    return Scene(*(
        torch.as_tensor(np.asarray(x, np.float32), device=dev)
        for x in (means, scales, q, opac, shs, colors)
    ))


def clone_trap_scene(device=None) -> Scene:
    """A scene for the exact per-pixel sort's edge cases, drawn with numpy.

    Framed by ``make_camera(32, 32)``. 56 faint (opacity 0.025), wide
    Gaussians around the origin, each cloned 5 times bit for bit (as
    densification's clone does, so their ray depths tie exactly): the
    central pixels hold ~280 actives, more than four lists of K7's 48 or 64
    entries, and do not saturate; a list boundary splits a group of clones
    (48, 64 and 96 are no multiples of 5). 12 opaque (0.6) Gaussians toward
    the lower right, each cloned twice: those pixels saturate (T < 1e-4)
    before their actives run out.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(1)

    def group(n, copies, opacity, center, spread, scale):
        means = center + rng.uniform(-spread, spread, (n, 3))
        means[:, 2] = rng.uniform(-0.5, 0.5, n)
        scales = scale * rng.uniform(0.8, 1.2, (n, 3))
        q = rng.standard_normal((n, 4))
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        opac = np.full((n,), opacity)
        shs = 0.5 * rng.standard_normal((n, 16, 3))
        colors = rng.uniform(0.0, 1.0, (n, 3))
        return [np.repeat(x, copies, axis=0)
                for x in (means, scales, q, opac, shs, colors)]

    faint = group(56, 5, 0.025, np.zeros(3), 0.3, 0.5)
    opaque = group(12, 2, 0.6, np.array([0.8, 0.8, 0.0]), 0.2, 0.3)
    return Scene(*(
        torch.as_tensor(np.concatenate([a, b]).astype(np.float32), device=dev)
        for a, b in zip(faint, opaque)
    ))


def png_chunk(ctype: bytes, payload: bytes) -> bytes:
    """One PNG chunk: length, type, payload and CRC."""
    crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)


def filtered_png(img: np.ndarray, filters) -> bytes:
    """The bytes of an 8-bit PNG of ``img`` ([H, W, C] uint8, C in 1-4)
    whose row y is written with filter type ``filters[y % len(filters)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), one IDAT chunk."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int32)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, c:] = cur[:, :-c]
    upleft = np.zeros_like(cur)
    upleft[:, c:] = up[:, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) >> 1, paeth])
    rows = np.arange(h)
    ft = np.asarray(filters, np.uint8)[rows % len(filters)]
    enc = ((cur - preds[ft, rows]) & 0xFF).astype(np.uint8)
    raw = np.concatenate([ft[:, None], enc], axis=1).tobytes()
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(raw, 6)) + png_chunk(b"IEND", b""))


def one_thread_under_xdist() -> None:
    """Run torch's CPU operators on one thread inside a pytest-xdist worker.

    Each worker would otherwise start as many intra-op threads as the host
    has cores, and several workers on one host then oversubscribe it many
    times over. The test files of the port call this when they are
    imported; outside xdist (``PYTEST_XDIST_WORKER`` unset) it does
    nothing. The inter-op pool is capped too, unless it has already been
    sized or started, which torch allows only once.
    """
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return
    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:
        pass


# The lines every rank of ``run_ranks`` runs first: one torch thread, the
# repository on sys.path, and the process group over the file store.
RANK_PREAMBLE = """
import sys
rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from stopthepop_tpu_torch.parallel import hosts
hosts.initialize(f"file://{workdir}/store", world, rank, device="cpu")
"""
# And last: no rank leaves the group while another is still in it.
RANK_POSTAMBLE = """
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def run_ranks(body: str, world: int, workdir, timeout: float = 600,
              env=None) -> List[dict]:
    """Run ``RANK_PREAMBLE + body + RANK_POSTAMBLE`` in ``world`` CPU
    processes that form one Gloo group through a file store in
    ``workdir`` (no TCP port). The body sees ``rank``, ``world`` and
    ``workdir`` and saves its results with
    ``np.savez(f"{workdir}/rank{rank}.npz", ...)``. Returns each rank's
    results in rank order. When a rank fails, or the run outlasts
    ``timeout`` seconds, every rank is killed and this raises with their
    output.
    """
    workdir = Path(workdir)
    script = workdir / "rank_worker.py"
    script.write_text(RANK_PREAMBLE + body + RANK_POSTAMBLE)
    repo = str(Path(__file__).resolve().parents[2])
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(workdir), repo],
        stdout=log, stderr=subprocess.STDOUT, env={**os.environ, **(env or {})})
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            p.wait()
            log.close()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed or timed out:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n"
            + (workdir / f"rank{r}.log").read_text()[-4000:]
            for r, p in enumerate(procs)))
    results = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
    return results
