"""Accuracy of torch's dense eigensolver and SVD drivers on a CUDA card.

``heat_tpu_torch.core.linalg._lapack`` chooses, for the factorizations of
``ht.linalg``, the driver behind ``torch.linalg.svd`` (``gesvd``, the QR
iteration) and a double-precision ``torch.linalg.eigh`` up to order 512
(where torch takes cuSOLVER's Jacobi, ``syevj``). This script prints the
numbers behind that choice on the card it runs on: for a float32 65536 x
1024 standard normal matrix each SVD driver's time, the orthonormality of
U and V, the reconstruction error and σ's error against float64 ``gesvd``;
for symmetric float32 matrices of order 16 to 2048 the eigenvalue and
orthonormality errors of torch's default ``eigh`` and of
``_lapack.accurate_eigh``, against float64.

    python3 scripts/torch_linalg_drivers.py        # on a card, from the repo root

It exits with an error without CUDA.
"""

from __future__ import annotations

import os
import sys

import torch


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _ortho(x: torch.Tensor) -> float:
    g = x.double().mT @ x.double()
    return float((g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_linalg_drivers: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from heat_tpu_torch.core.linalg import _lapack

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(65536, 1024, device=dev, generator=gen)
    ref = torch.linalg.svdvals(a.double(), driver="gesvd")
    for driver in (None, "gesvdj", "gesvd"):
        u, s, vh = torch.linalg.svd(a, full_matrices=False, driver=driver)
        ms = _ms(lambda: torch.linalg.svd(a, full_matrices=False, driver=driver))
        recon = float((a.double() - (u.double() * s.double()) @ vh.double()).norm() / a.double().norm())
        print(f"svd 65536x1024 float32 driver={driver}: {ms:.2f} ms, U {_ortho(u):.2e}, V {_ortho(vh.mT):.2e}, "
              f"reconstruction {recon:.2e}, max |Δσ|/σ_max {float((s.double() - ref).abs().max() / ref[0]):.2e}",
              flush=True)
    del a, u, vh
    for n in (16, 33, 64, 128, 266, 512, 1024, 2048):
        x = torch.randn(n, n, device=dev, generator=gen)
        x = (x + x.T) / (2 * n) ** 0.5
        w64 = torch.linalg.eigvalsh(x.double())
        for name, fn in (("torch.linalg.eigh", torch.linalg.eigh), ("accurate_eigh", _lapack.accurate_eigh)):
            w, v = fn(x)
            print(f"eigh {n}² float32, {name}: max |Δλ|/‖A‖₂ "
                  f"{float((w.double() - w64).abs().max() / w64.abs().max()):.2e}, orthonormality {_ortho(v):.2e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
