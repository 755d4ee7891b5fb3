#!/usr/bin/env python
"""The RMSNorm kernels at one width, their own instance against the
generic route, in one process on one card.

``csrc/rmsnorm.cu`` gives a few widths a forward that keeps the row in
registers and a backward that streams rows through a shared-memory ring
(``RESIDENT_WIDTHS`` / ``BWD_RING_WIDTHS`` in ``kernels/rmsnorm.py``);
every other width takes the generic kernels.  This script builds the
library as it stands and a copy whose ``rmsnorm.cu`` has the width's
instances taken out (so the width takes the generic kernels), holds both
against the plain versions, and times the forward and the backward of
each at ``rows x width`` bf16 with the L2 emptied before every call
(``chip_smoke.time_ms(cold=True, device_only=True)``), in the order own,
generic, generic, own.  It prints one JSON line.

    python3 tools/rmsnorm_width_ab.py --width 2048 --rows 4096

Needs a CUDA card and ``nvcc``; the copy builds under
``build/kernels/ab_<width>/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402


def _generic_copy(width: int) -> Path:
    """The library with ``width``'s forward and backward instances taken
    out of ``rmsnorm.cu``."""
    from repro_torch.kernels import _build

    out = _build.BUILD_ROOT / f"ab_{width}"
    lib = out / _build.LIB_NAME
    if lib.is_file():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    fwd = re.compile(rf"  if \(vec_ok && d == {width}\)\n.*?stream\);\n",
                     re.S)
    bwd = re.compile(rf"      case {width}:\n.*?stream\);\n", re.S)
    cut = bwd.sub("", fwd.sub("", src, count=1), count=1)
    if cut == src or f"d == {width}" in cut or f"case {width}:" in cut:
        raise SystemExit(f"rmsnorm.cu has no instances of width {width}")
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for s in _build._sources():
        path = s
        if s.name == "rmsnorm.cu":
            path = out / "rmsnorm.cu"
            path.write_text(cut)
        obj = out / f"{s.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-c", str(path),
             "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{log}")
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--rows", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_width_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RN

    d, rows = args.width, args.rows
    if d not in RN.RESIDENT_WIDTHS or d not in RN.BWD_RING_WIDTHS:
        raise SystemExit(f"width {d} has no instances to compare")
    libs = {"own": _build.load_library()}
    generic = ctypes.CDLL(str(_generic_copy(d)))
    _build._declare(generic)
    libs["generic"] = generic
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((rows, d), generator=g, device="cuda").bfloat16()
    dy = torch.randn((rows, d), generator=g, device="cuda").bfloat16()
    sc = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")).bfloat16()
    want_y = RN.rmsnorm(x, sc, impl="plain")
    want_dx, want_ds = RN.rmsnorm_bwd(x, sc, dy, impl="plain")
    times = {k: {"fwd": [], "bwd": []} for k in libs}
    errs = {}
    for name in ("own", "generic", "generic", "own"):
        _build._lib = libs[name]
        y = RN.rmsnorm(x, sc)
        dx, ds = RN.rmsnorm_bwd(x, sc, dy)
        torch.cuda.synchronize()
        ok_y, e_y = C.close(y, want_y, **C.BF16_TOL)
        ok_x, e_x = C.close(dx, want_dx, **C.BF16_TOL)
        ok_s, e_s = C.close(ds, want_ds, **C.BF16_TOL)
        if not (ok_y and ok_x and ok_s):
            raise SystemExit(f"{name}: disagrees with the plain versions")
        errs[name] = dict(y=e_y, dx=e_x, dscale=e_s)
        times[name]["fwd"].append(C.time_ms(lambda: RN.rmsnorm(x, sc),
                                            reps=50, cold=True,
                                            device_only=True))
        times[name]["bwd"].append(C.time_ms(lambda: RN.rmsnorm_bwd(x, sc, dy),
                                            reps=50, cold=True,
                                            device_only=True))
    _build._lib = libs["own"]
    fb, fby, _ = C.rmsnorm_bound(rows, d, 2)
    bb, bby, _ = C.rmsnorm_bwd_bound(rows, d, 2)
    print(json.dumps({"rmsnorm_width_ab": dict(
        rows=rows, d=d, dtype="bf16", smi=C.smi_line(),
        cold_device_ms={k: {p: statistics.mean(v) for p, v in t.items()}
                        for k, t in times.items()},
        cold_device_ms_each=times, max_abs_err=errs,
        bound_ms=dict(fwd=fb, bwd=bb), bound_by=dict(fwd=fby, bwd=bby))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
