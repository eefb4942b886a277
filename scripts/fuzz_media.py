"""Fuzz the media decoders' C entropy stages (``csrc/host/media.c``) under
AddressSanitizer and UndefinedBehaviorSanitizer.

Builds the source with ``-fsanitize=address,undefined`` into a temporary
directory, binds the port's decoders to that build, and decodes mutated
and truncated JPEG (baseline, progressive, restart intervals), GIF and
APNG files (bit flips, byte sets, insertions, cuts): every file must
decode or raise ValueError, and the sanitizers must report nothing. The
sanitizer runtimes must be loaded first, so run it as

    LD_PRELOAD=$(cc -print-file-name=libasan.so):$(cc -print-file-name=libubsan.so) \\
        ASAN_OPTIONS=detect_leaks=0 python scripts/fuzz_media.py [N] [--seed S]

(CPU only, no PIL needed: the seed files come from ``testing/synth_media``;
``tests/test_torch_jpeg.py`` and ``tests/test_torch_gif_apng.py`` run the
same mutations, unsanitized, under hypothesis).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import random
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from llms_on_kubernetes_tpu_torch import kernels  # noqa: E402
from llms_on_kubernetes_tpu_torch.engine import images  # noqa: E402
from llms_on_kubernetes_tpu_torch.testing import synth_media  # noqa: E402


def sanitized_build(out_dir: str) -> str:
    path = os.path.join(out_dir, "media_san.so")
    cc = kernels._host_compiler()
    subprocess.run([*cc, "-O1", "-g", "-fsanitize=address,undefined", "-fno-omit-frame-pointer",
                    "-shared", "-fPIC", "-o", path, str(kernels.HOST_CSRC / "media.c")],
                   check=True)
    return path


def seeds(rng) -> list[bytes]:
    pic = rng.integers(0, 256, (21, 37, 3), dtype=np.uint8)
    out = [synth_media.encode_jpeg(pic, q, sub, restart=r)
           for q, sub, r in ((50, "420", 0), (90, "444", 1), (75, "422", 3), (60, "440", 0))]
    out.append(synth_media.encode_jpeg(pic[..., 0], 80))
    out.append(synth_media.encode_gif(
        [rng.integers(0, 8, (6, 7), dtype=np.uint8) for _ in range(3)],
        rng.integers(0, 256, (8, 3), dtype=np.uint8), disposal=[2, 3, 1],
        transparency=[None, 1, 2], interlace=[False, True, False]))
    out.append(synth_media.encode_gif(           # frames that grow a too-small screen
        [rng.integers(0, 8, (6, 7), dtype=np.uint8) for _ in range(3)],
        rng.integers(0, 256, (8, 3), dtype=np.uint8), disposal=[3, 2, 1],
        transparency=[1, None, 2], rects=[(2, 1), (5, 4), (0, 6)], screen=(4, 3)))
    out.append(synth_media.encode_apng(
        [rng.integers(0, 256, (5, 6, 4), dtype=np.uint8) for _ in range(3)],
        dispose=[1, 2, 0], blend=[0, 1, 1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=20_000, help="mutated files")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        lib = ctypes.CDLL(sanitized_build(d))
        for symbol, (_lib, argtypes) in kernels._HOST_SIGNATURES.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            kernels._host_funcs[symbol] = fn
        rnd = random.Random(args.seed)
        bases = seeds(np.random.default_rng(args.seed))
        decoded = refused = 0
        for _ in range(args.n):
            raw = bytearray(rnd.choice(bases))
            for _ in range(rnd.randint(1, 8)):
                op, i = rnd.random(), rnd.randrange(len(raw))
                if op < 0.5:
                    raw[i] ^= 1 << rnd.randrange(8)
                elif op < 0.7:
                    raw[i] = rnd.choice([0x00, 0xFF, 0xD0, 0xD9, 0xC4, 0xDA, 0x21, 0x2C, 0x3B])
                elif op < 0.85:
                    raw[i:i] = bytes(rnd.randrange(256) for _ in range(rnd.randint(1, 10)))
                else:
                    del raw[i:]
                if len(raw) < 8:
                    break
            try:
                images.decode_video_frames(bytes(raw), range(3))
                decoded += 1
            except ValueError:
                refused += 1
    print(f"{args.n} mutated files: {decoded} decoded, {refused} refused with ValueError "
          f"(a sanitizer report above, if any, is a fault)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
