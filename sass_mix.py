#!/usr/bin/env python3
"""Counts the instructions of the mask probe's two kernels' innermost
loops (``csrc/probe_mask_replay_check.cu``, queue B row 17f), by the H100
pipe that issues them, from the machine code (SASS) that ``nvcc`` built
for ``sm_90a``, and prices the XLong layer's four masks on each pipe.

    python3 sass_mix.py [--out sass_mix.json] [--dump masks.sass]

It builds the source as the port does (``ops/_cuda.py``), disassembles
the library with ``cuobjdump -sass`` (beside ``nvcc``), and finds in each
kernel its innermost loops: the spans from a backward branch's target to
the branch that hold no other such span.  For each loop it counts the
instructions by class and divides by the fp32 elements the loop's global
or generic stores (STG, ST) write (a 16-byte store four, an 8-byte one
two, any other one), so a loop unrolled by the compiler counts the same
per element.  The compiler unswitches each kernel's loop on ``dr.on``:
the loop that draws the masks holds the IMAD.WIDE and LOP3 of Philox, the
other stores ones (``--dump`` writes the disassembly).  Classes (the
pipes of Nsight Compute's names):

  alu       integer and logic: LOP3, IADD3, ISETP, SEL, FSEL, SHF, LEA, MOV, ...
  fmaheavy  integer multiplies: IMAD (IMAD.WIDE, .HI, .MOV, ...), IMUL
  fp32      FFMA, FADD, FMUL, FMNMX, FSETP (and the fp16 pairs HFMA2, HADD2, HMUL2)
  xu        MUFU and the conversions (I2F, F2I, ...)
  mem       loads and stores, local, shared and global
  uniform   the warp's uniform datapath (U*, S2UR, R2UR)
  control   branches, barriers, S2R and the rest

and prices ``ELEMS`` elements on each pipe at the H100 SXM's rates (132
SMs at the 1.98 GHz behind its 67 TFLOP/s fp32 peak; 64 lanes an SM for
alu and fmaheavy, 128 for fp32 on both halves of the FMA pair, 16 for xu,
and one warp instruction a clock on each of an SM's four schedulers for
every instruction but NOP), beside the bytes of the elements written
once at 3.35 TB/s.  An instruction this table does not name is counted as
``other`` and listed.  Prints one JSON object a kernel, and writes them
all to ``--out`` if given, the whole disassembly to ``--dump``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

SOURCE = "probe_mask_replay_check.cu"
KERNELS = ("masks_forward_kernel", "masks_reversed_kernel")
ELEMS = 512 * 1024 * (64 + 64 + 256 + 64)   # the XLong layer's four masks
SMS = 132
CLOCK_HZ = 67e12 / (SMS * 256)   # the fp32 peak's clock: 128 lanes, an FMA counting two
BYTES_PER_S = 3.35e12
LANES = {"alu": 64, "fmaheavy": 64, "fp32": 128, "xu": 16}
DISPATCH_LANES = 4 * 32          # four schedulers a warp instruction a clock each

_CLASSES = (
    ("uniform", re.compile(r"^(U[A-Z0-9]+|S2UR|R2UR)$")),
    ("fmaheavy", re.compile(r"^(IMAD|IMUL|IDP)")),
    ("fp32", re.compile(r"^(FFMA|FADD|FMUL|FMNMX|FSETP|FCHK|HFMA2|HADD2|HMUL2)")),
    ("xu", re.compile(r"^(MUFU|I2F|F2I|F2F|FRND|I2I|F2FP|I2FP|F2IP)")),
    ("mem", re.compile(r"^(LDG|STG|LDS|STS|LDL|STL|LDC|LD|ST|ATOM|ATOMG|ATOMS|RED|LDGSTS|"
                       r"LDSM|CCTL|MEMBAR|ERRBAR|FENCE)$")),
    ("alu", re.compile(r"^(LOP3|LOP|IADD3|IADD|VIADD|VIADDMNMX|ISETP|SEL|FSEL|SHF|SHL|SHR|LEA|"
                       r"MOV|IABS|IMNMX|VIMNMX|PRMT|PLOP3|P2R|R2P|ISCADD|FLO|POPC|BMSK|SGXT|"
                       r"BREV|CS2R|IMNMX3)$")),
    ("control", re.compile(r"^(BRA|BRX|JMP|JMX|CALL|RET|EXIT|BSSY|BSYNC|BREAK|BAR|WARPSYNC|"
                           r"YIELD|NOP|S2R|VOTE|VOTEU|DEPBAR|KILL|BPT|NANOSLEEP|SHFL|ELECT|"
                           r"ACQBULK|WARPGROUP)$")),
)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
                   r"((?:\.[A-Z0-9_]+)*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def classify(op: str) -> str:
    for name, pattern in _CLASSES:
        if pattern.match(op):
            return name
    return "other"


def parse(sass: str) -> dict[str, list[tuple[int, str, str, str]]]:
    """{function: [(offset, opcode, modifiers, operands)]}, branch targets
    given as labels turned into offsets."""
    funcs: dict[str, list] = {}
    labels: dict[str, dict[str, int]] = {}
    cur, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur, pending = m.group(1), []
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            off = int(m.group(1), 16)
            for label in pending:
                labels[cur][label] = off
            pending = []
            funcs[cur].append((off, m.group(3), m.group(4), m.group(5).strip()))
    for name, insns in funcs.items():
        for i, (off, op, mods, args) in enumerate(insns):
            if op in ("BRA", "JMP"):
                m = re.search(r"\.L_x_\d+", args)
                if m and m.group(0) in labels[name]:
                    insns[i] = (off, op, mods, hex(labels[name][m.group(0)]))
    return funcs


def innermost_loops(insns):
    """[(start, end)] of the backward branches' spans that hold no other
    (a branch to itself, the trap after a kernel's EXIT, is none)."""
    spans = []
    for off, op, _, args in insns:
        if op in ("BRA", "JMP"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < off:
                spans.append((int(m.group(1), 16), off))
    return [s for s in spans
            if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]


def store_elems(mods: str) -> int:
    """fp32 elements one global store writes, by its width."""
    return 4 if ".128" in mods else 2 if ".64" in mods else 1


def loop_mix(insns, span, elems):
    body = [i for i in insns if span[0] <= i[0] <= span[1]]
    counts = Counter(classify(op) for _, op, _, _ in body)
    per_iter = sum(store_elems(mods) for _, op, mods, _ in body if op in ("STG", "ST"))
    others = sorted({op for _, op, _, _ in body if classify(op) == "other"})
    issued = sum(1 for _, op, _, _ in body if op != "NOP")
    out = {"span": [hex(span[0]), hex(span[1])], "instructions": len(body),
           "elements_per_iteration": per_iter,
           "opcodes": dict(Counter(op for _, op, _, _ in body).most_common())}
    if not per_iter:
        out["note"] = "no global or generic store in the loop"
        return out
    per_elem = {k: v / per_iter for k, v in sorted(counts.items())}
    ms = {k: elems * per_elem.get(k, 0.0) / (SMS * LANES[k] * CLOCK_HZ) * 1e3 for k in LANES}
    ms["issue"] = elems * issued / per_iter / (SMS * DISPATCH_LANES * CLOCK_HZ) * 1e3
    ms["bytes"] = elems * 4 / BYTES_PER_S * 1e3
    out.update(per_element=per_elem, ms_at_elems=ms, bound_by=max(ms, key=ms.get),
               other_opcodes=others)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--dump", type=Path)
    args = ap.parse_args(argv)

    from datamining_recblr_torch.ops import _cuda

    _cuda.build((SOURCE,))
    lib = _cuda._lib_path(SOURCE)
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    if args.dump:
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        args.dump.write_text(sass)
    funcs = parse(sass)
    results = []
    for want in KERNELS:
        found = [f for f in funcs if want in f]
        if not found:
            print(f"sass_mix: no function holds {want!r} in {lib.name}", file=sys.stderr)
            return 1
        for fname in found:
            loops = [loop_mix(funcs[fname], s, ELEMS) for s in innermost_loops(funcs[fname])]
            res = {"source": SOURCE, "kernel": want, "function": fname,
                   "instructions": len(funcs[fname]), "elems": ELEMS, "loops": loops}
            print(json.dumps(res), flush=True)
            results.append(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
