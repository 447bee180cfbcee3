"""Whether two builds of the column-physics library hold the same machine
code for each kernel they share.

    python -m speedy_tpu_torch.sass_diff OLD.so NEW.so

Disassembles both shared libraries with ``cuobjdump -sass`` (CUDA toolkit,
on the machine with the card) and, for every instantiation of
``column_physics_kernel`` keyed by its template arguments (type, kx, SW,
members, and the LW order, absent from builds that predate it and then
read as the default order), prints whether the two instruction streams are
identical (addresses and encodings aside), and the instantiations only one
library has. Exits 1 if a shared instantiation differs. Used to show that
adding a variant left the default kernels as they were: a parent
checkout's library against this one's.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

KERNEL = re.compile(r"column_physics_kernelI([fd])Li(\d)ELb([01])ELb([01])E"
                    r"(?:Lb([01])E)?")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*")


def cuobjdump() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump"),
                 shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def kernels(library: str) -> dict:
    """{(type, kx, sw, members, reflw): [instruction, ...]} of a library's
    column-physics kernels."""
    out = subprocess.run([cuobjdump(), "-sass", library], check=True,
                         capture_output=True, text=True).stdout
    found, key = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = KERNEL.search(line)
            key = None
            if m:
                key = m.groups()[:4] + (m.group(5) or "0",)
                found[key] = []
        elif key is not None:
            m = INSTRUCTION.search(line)
            if m:
                found[key].append(m.group(1))
    return found


def name(key) -> str:
    t, kx, sw, members, reflw = key
    return (f"{'fp32' if t == 'f' else 'fp64'} kx={kx} "
            f"{'sw' if sw == '1' else 'nosw'}"
            f"{' members' if members == '1' else ''}"
            f"{' reflw' if reflw == '1' else ''}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (kernels(p) for p in argv)
    same = True
    for key in sorted(old.keys() | new.keys()):
        if key not in old or key not in new:
            print(f"{name(key)}: only in {'new' if key in new else 'old'}")
            continue
        equal = old[key] == new[key]
        same &= equal
        print(f"{name(key)}: {len(new[key])} instructions, "
              f"{'identical' if equal else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
