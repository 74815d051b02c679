"""The dropout draw's kept-element division, three ways, on the card: the
kernel as built (``div_keep``: x * RN(1/keep) and one residual correction),
a build with two corrections, and a build that takes ``__fdiv_rn`` at every
keep; and a build whose ``div_keep`` domain has no lower edge. Each build's
``check_division`` (pairs of every bf16 x and every f32 keep in [0.5, 1)
whose f32 / bf16 results differ from ``__fdiv_rn``), then the three timed
builds at ``chip_smoke.py``'s four draw sites by graph replay, in turns
(one, two, fdiv, fdiv, two, one, twice), each checked bit-equal to the
plain version. The variants are text edits of ``csrc/dropout_draw.cu``,
built under ``build/draw_division_ab``. Needs one GPU:

    python tools/draw_division_ab.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402
from dlsc_tpu_torch import _kernels  # noqa: E402
from dlsc_tpu_torch.ops import dropout_draw as D  # noqa: E402

ONE = "  return __fmaf_rn(__fmaf_rn(-keep, q, x), y, q);"
TWO = ("  const float q1 = __fmaf_rn(__fmaf_rn(-keep, q, x), y, q);\n"
       "  return __fmaf_rn(__fmaf_rn(-keep, q1, x), y, q1);")
FAST_KEEP = "if (keep >= 0.5f && keep < 1.0f)"
EXP_MIN = "EXP_MIN = 27,"


def variants(src: str) -> dict[str, str]:
    for s in (ONE, FAST_KEEP, EXP_MIN):
        assert s in src, s
    return {"one": src, "two": src.replace(ONE, TWO), "fdiv": src.replace(FAST_KEEP, "if (false)"),
            "no_lower_edge": src.replace(EXP_MIN, "EXP_MIN = 0,")}


def build(name: str, text: str, out: Path) -> subprocess.Popen:
    (out / f"{name}.cu").write_text(text)
    return subprocess.Popen([_kernels._nvcc(), *_kernels._flags("dropout_draw"), "-o",
                             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def main() -> None:
    print(C.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    out = ROOT / "build" / "draw_division_ab"
    out.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "dlsc_tpu_torch" / "csrc" / "dropout_draw.cu").read_text()
    procs = {k: build(k, t, out) for k, t in variants(src).items()}
    proto = D._lib()
    libs = {}
    for k, p in procs.items():
        _, err = p.communicate()
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(out / f"lib{k}.so"))
        for fn in ("dlsc_dropout_draw", "dlsc_dropout_div_check", "dlsc_error_string"):
            getattr(lib, fn).argtypes = getattr(proto, fn).argtypes
            getattr(lib, fn).restype = getattr(proto, fn).restype
        libs[k] = lib
        D._lib = lambda lib=lib: lib
        print(f"{k}: check_division (f32, bf16 pairs that differ) {D.check_division(dev)}",
              flush=True)
    g = torch.Generator(dev).manual_seed(3)
    for name, shape, by_row in C.DRAW_SITES:
        a = C._draw_args(shape, by_row, dev, g)
        args = (a["x"], a["seeds"], a["keep"], a["block"], a["site"], a["strides"], a["base"],
                a["row_ids"])
        want = D._plain(1, *args)
        ms = {k: [] for k in ("one", "two", "fdiv")}
        for k in ["one", "two", "fdiv", "fdiv", "two", "one"] * 2:
            D._lib = lambda lib=libs[k]: lib
            assert torch.equal(D._run(1, *args), want), (name, k)
            ms[k].append(C.graph_ms(lambda: D._run(1, *args)))
        print(f"{name}: " + ", ".join(f"{k} {np.median(v):.4f} ms ({min(v):.4f}-{max(v):.4f})"
                                      for k, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
