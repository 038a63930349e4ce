"""What the compiler made of the kernels, read from the built library: each
kernel's registers and shared memory (``cuobjdump -res-usage``) and the
IMAD-pipe issue slots of a kernel's loop (``cuobjdump -sass``).

    python -m zerog_tpu_torch.bench.sass [LIB]

prints, for the kernel library at LIB (by default the one
:func:`zerog_tpu_torch.kernels.build` makes), one JSON line a kernel with its
resource usage, then the IMAD-pipe slots of one Montgomery product: the loop
of ``field_chain_kernel<1>`` (one ``fe_mul<1>`` an iteration) counted by
opcode, beside :data:`IMAD_SLOTS_PER_MUL`. It needs ``cuobjdump`` (beside
``nvcc`` in the CUDA toolkit), not a card.

The bounds of :mod:`zerog_tpu_torch.bench` count a product as the slots it
takes on the pipe that runs 32-bit multiply-adds, 64 lanes a clock an SM:
``IMAD``, ``IMAD.HI``, ``IMAD.X``, ``IMAD.MOV``, ``IMAD.IADD`` and
``IMAD.SHL`` take one slot each, ``IMAD.WIDE`` (a 64-bit result) two.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from collections import Counter

from .. import kernels
from . import IMAD_SLOTS_PER_MUL

__all__ = ["cuobjdump", "parse_res_usage", "parse_sass", "loop_body",
           "imad_slots", "res_usage", "slots_per_mul", "main"]

# the kernel whose loop is one product (field_chain's inner loop, Fr)
MUL_LOOP_KERNEL = "field_chain_kernel<1>"
MUL_LOOP_PRODUCTS = 1
# IMAD opcodes by class and their slots; the first class whose modifier the
# opcode carries is its class
IMAD_CLASSES = (("IMAD.WIDE", 2), ("IMAD.HI", 1), ("IMAD.X", 1), ("IMAD.MOV", 1),
                ("IMAD.IADD", 1), ("IMAD.SHL", 1))

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")


def cuobjdump(*args: str) -> str:
    """The output of the CUDA toolkit's ``cuobjdump`` (beside ``nvcc``)."""
    exe = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          check=True).stdout


def parse_res_usage(text: str) -> dict:
    """``cuobjdump -res-usage`` output -> {kernel: {registers, shared, stack,
    local}} (bytes but registers), names as :func:`kernels.demangle` gives
    them."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function ([^\s:]+):", line)
        if m:
            name = kernels.demangle(m.group(1))
            continue
        if name is not None and "REG:" in line:
            vals = dict(re.findall(r"(\w+):(\d+)", line))
            out[name] = dict(registers=int(vals["REG"]), shared=int(vals["SHARED"]),
                             stack=int(vals["STACK"]), local=int(vals["LOCAL"]))
            name = None
    return out


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {kernel: [(address, instruction), ...]},
    each instruction's text without its predicate guard, a branch target
    given as a label (`` `(.L_x_1)``) replaced by its address."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = kernels.demangle(m.group(1))
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending = []
            funcs[name].append((addr, re.sub(r"^@!?U?P\w+\s+", "", m.group(2))))

    def resolve(name, text_):
        return re.sub(r"`\((\.L_x_\d+)\)", lambda m: hex(labels[name][m.group(1)]), text_)

    return {name: [(a, resolve(name, t)) for a, t in instrs]
            for name, instrs in funcs.items()}


def loop_body(instrs) -> list:
    """The instructions of the innermost loop of a kernel: from the target of
    the backward branch that spans the fewest instructions up to that
    branch. Raises if the kernel has no backward branch."""
    best = None
    for i, (addr, text) in enumerate(instrs):
        m = re.match(r"BRA\b.*?(0x[0-9a-f]+)$", text)
        if not m or int(m.group(1), 16) >= addr:   # forward, or the end's self-branch
            continue
        target = int(m.group(1), 16)
        start = next(j for j, (a, _) in enumerate(instrs) if a >= target)
        if best is None or i - start < best[1] - best[0]:
            best = (start, i)
    if best is None:
        raise ValueError("no backward branch: the kernel has no loop")
    return instrs[best[0]:best[1] + 1]


def imad_slots(instrs) -> tuple[dict, int]:
    """({class: count} of the IMAD-pipe instructions among `instrs`, the
    slots they take): :data:`IMAD_CLASSES`, a plain ``IMAD`` otherwise."""
    counts = Counter()
    slots = 0
    for _, text in instrs:
        op = text.split()[0]
        if not op.startswith("IMAD"):
            continue
        mods = set(op.split(".")[1:])
        cls, n = next(((c, n) for c, n in IMAD_CLASSES if c.split(".")[1] in mods),
                      ("IMAD", 1))
        counts[cls] += 1
        slots += n
    return dict(sorted(counts.items())), slots


def res_usage(lib_path: str) -> dict:
    """{kernel: {registers, shared, stack, local}} of the library at
    `lib_path`."""
    return parse_res_usage(cuobjdump("-res-usage", lib_path))


def slots_per_mul(lib_path: str) -> dict:
    """The IMAD-pipe slots of one ``fe_mul<1>``, read from the loop of
    MUL_LOOP_KERNEL in the library at `lib_path`: the loop's IMAD classes
    and all its opcodes counted, its slots over its products, and whether
    that equals :data:`IMAD_SLOTS_PER_MUL`."""
    instrs = parse_sass(cuobjdump("-sass", lib_path))[MUL_LOOP_KERNEL]
    body = loop_body(instrs)
    counts, slots = imad_slots(body)
    per_mul = slots / MUL_LOOP_PRODUCTS
    ops = Counter(text.split()[0] for _, text in body)
    return dict(kernel=MUL_LOOP_KERNEL, loop_instructions=len(body),
                products_in_loop=MUL_LOOP_PRODUCTS, opcodes=counts,
                all_opcodes=dict(sorted(ops.items())),
                slots_per_mul=per_mul, constant=IMAD_SLOTS_PER_MUL,
                matches_constant=per_mul == IMAD_SLOTS_PER_MUL)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else kernels.build()
    for name, use in sorted(res_usage(path).items()):
        print(json.dumps(dict(kernel=name, **use)), flush=True)
    print(json.dumps(slots_per_mul(path)), flush=True)


if __name__ == "__main__":
    main()
