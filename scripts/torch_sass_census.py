#!/usr/bin/env python3
"""Count the SASS instructions of the port's rollout kernels by class, per
rollout-step.

    python3 scripts/torch_sass_census.py [--root DIR] [--dump DIR]
    python3 scripts/torch_sass_census.py --sass DIR   # from dumped SASS, no toolkit

Builds the kernels of ``--root`` (default: this checkout; kernels/build.py)
and disassembles each rollout library with ``cuobjdump -sass``; ``--sass``
reads the ``<library>.sass`` files an earlier ``--dump`` wrote instead. In
each kernel function (kernel 1 = ``pair_sample_rollout_kernel<false>``,
kernel 3 = ``pair_sample_rollout_kernel<true>``, kernel 2 =
``pair_rollout_kernel<C>`` at one and at 4 scenarios) it finds the step
loop, the longest backward branch, whose body runs once per rollout-step.
Each kernel is a pair of warps that run one step loop between them: each
skips the other's part of it. Its two role regions are
the two longest forward branches inside the loop that do not overlap and
stay inside it; the one with more FP32 arithmetic is the dynamics warp's
(the mass matrix, Cholesky and Euler), the other the cost warp's (the cost
terms); the rest (FK, the select, the ring, loop control) is shared, so a
role's count per step is the loop's minus the other role's region (the
short parts before FK, the loads and the ring's pop, count as shared). It
counts the instructions by class: FP32 arithmetic (FFMA, FMUL, FADD), the FP32
pipe's other instructions (compares, selects, min/max, FCHK), MUFU, calls
(the out-of-line slow paths of IEEE division, reciprocal and sqrt, told
apart by their bodies), local memory (LDL/STL: spills and local arrays),
integer, global/shared/constant memory, mbarrier operations (SYNCS),
conversions, moves, uniform-datapath and control.

Everything of the step body is unrolled into its loop, so a loop's static
count is its count per rollout-step, with code that runs only when a check
fails or a value is not there yet: the calls above, and the loops nested in
the step loop, each the Payne-Hanek range reduction of one
sinf/cosf/sincosf argument beyond ~1e5 (its own backward branch, local
array and STL, ``slow_path_loops``). A wait on a ring slot (SYNCS
try-wait) retries out of line, after the function's exit, and its way back
into the loop is not a loop of its own: a backward branch within a few
instructions after a try-wait is left out.

For kernel 3 it also lists where the Philox
products (IMAD.WIDE.U32 by the two Philox multipliers, which SASS prints as
signed immediates) sit in the loop: its loop over the three calls stays
rolled, so one call's ~20 products sit in one span a few instructions
apart.

Prints one JSON line; ``--dump DIR`` also writes each library's SASS there.
Needs nvcc and cuobjdump (the CUDA toolkit) unless ``--sass`` is given, and
no card.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);"
)
ADDRESS = re.compile(r"^\s*(0x[0-9a-f]+)")
# Per kernel: library, a fragment of the function's mangled name, and its
# step loops (one per warp role).
FUNCTIONS = {
    "kernel1_fused_sample_rollout": ("fused_sample_rollout", "pair_sample_rollout_kernelILb0E", 2),
    "kernel3_inkernel_rng_sample_rollout": ("inkernel_rng_sample_rollout", "pair_sample_rollout_kernelILb1E", 2),
    "kernel2_rollout_x1": ("rollout", "pair_rollout_kernelILi1E", 2),
    "kernel2_rollout_x4": ("rollout", "pair_rollout_kernelILi4E", 2),
}
LIBRARIES = sorted({library for library, _, _ in FUNCTIONS.values()})
# The Philox4x32 multipliers 0xD2511F53 and 0xCD9E8D57 as SASS prints them.
PHILOX = ("-0x2daee0ad", "-0x326172a9")
CLASSES = {
    "fp32_arith": {"FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I"},
    "fp32_other": {"FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "FRND", "FSWZADD"},
    "mufu": {"MUFU"},
    "call": {"CALL"},
    "local_memory": {"LDL", "STL"},
    "integer": {"IMAD", "IADD3", "IADD", "ISETP", "IMNMX", "IABS", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
                "SEL", "PRMT", "POPC", "FLO", "BREV", "IMUL", "ISCADD", "IDP", "VIADD", "VIMNMX", "PLOP3"},
    "memory": {"LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "ULDC", "LDGSTS", "ATOM", "RED"},
    "mbarrier": {"SYNCS"},
    "conversion": {"F2F", "F2I", "I2F", "I2FP", "F2IP"},
    "move": {"MOV", "MOV32I", "S2R", "CS2R", "S2UR", "R2UR", "SHFL", "HFMA2"},
    "control": {"BRA", "BSSY", "BSYNC", "EXIT", "RET", "BAR", "WARPSYNC", "NOP", "YIELD", "BMOV", "JMP", "BREAK"},
}


def classify(opcode: str, modifiers: str) -> str:
    if opcode == "IMAD" and modifiers.startswith(".MOV"):
        return "move"
    if opcode == "HFMA2" and modifiers == ".MMA":  # the compiler's zero/constant move
        return "move"
    if opcode.startswith("U") and opcode not in CLASSES["memory"]:
        return "uniform"
    for name, opcodes in CLASSES.items():
        if opcode in opcodes:
            return name
    return "other"


def parse(sass: str) -> dict:
    """{function name: [(address, opcode, modifiers, operands)]}."""
    functions = {}
    name = None
    for line in sass.splitlines():
        match = re.search(r"Function : (\S+)", line)
        if match:
            name = match.group(1)
            functions[name] = []
            continue
        match = INSTRUCTION.match(line) if name else None
        if match:
            functions[name].append((int(match.group(1), 16), match.group(2), match.group(3), match.group(4).strip()))
    return functions


def target(operands: str):
    match = ADDRESS.match(operands)
    return int(match.group(1), 16) if match else None


def is_try_wait(instruction) -> bool:
    return instruction[1] == "SYNCS" and "TRYWAIT" in instruction[2]


def backward_branches(instructions: list) -> list:
    """(start, end) spans of every backward branch, longest first, but for
    the branches of an out-of-line try-wait retry (up to 3 instructions
    after a SYNCS try-wait)."""
    spans = []
    for k, (address, opcode, _, operands) in enumerate(instructions):
        to = target(operands) if opcode == "BRA" else None
        if to is not None and to < address and not any(map(is_try_wait, instructions[max(0, k - 3):k])):
            spans.append((to, address))
    return sorted(spans, key=lambda span: span[0] - span[1])


def subroutine_kind(instructions: list, entry: int) -> str:
    """What an out-of-line callee is, from its body (entry up to its RET):
    IEEE division checks its quotient with FFMA.RZ, the reciprocal slow
    path refines a MUFU.RCP, the sqrt one a MUFU.RSQ."""
    body = []
    for ins in instructions:
        if ins[0] >= entry:
            body.append(ins)
            if ins[1] == "RET":
                break
    kinds = {opcode + modifiers for _, opcode, modifiers, _ in body}
    if "FFMA.RZ" in kinds:  # the quotient's rounding check: IEEE division
        return "division"
    return "reciprocal" if "MUFU.RCP" in kinds else "sqrt" if "MUFU.RSQ" in kinds else "other"


def census(instructions: list, span=None) -> dict:
    """The class census of the step loop, or of the instructions in
    ``span`` (start, end) of it."""
    spans = backward_branches(instructions)
    if not spans:
        raise RuntimeError("no backward branch: the step loop was not found")
    start, end = span or spans[0]
    loop = [ins for ins in instructions if start <= ins[0] <= end]
    nested = [(a, b) for a, b in spans[1:] if start <= a and b <= end]
    in_nested = [ins for ins in loop if any(a <= ins[0] <= b for a, b in nested)]
    classes = collections.Counter(classify(opcode, modifiers) for _, opcode, modifiers, _ in loop)
    calls = collections.Counter(
        subroutine_kind(instructions, target(operands)) for _, opcode, _, operands in loop if opcode == "CALL"
    )
    out = {
        "loop_instructions": len(loop),
        "function_instructions": len(instructions),
        "loop": dict(sorted(classes.items())),
        "fp32_arith_by_opcode": dict(sorted(collections.Counter(
            opcode for _, opcode, _, _ in loop if classify(opcode, "") == "fp32_arith").items())),
        "mufu_by_function": dict(sorted(collections.Counter(
            modifiers for _, opcode, modifiers, _ in loop if opcode == "MUFU").items())),
        "slow_path_calls": dict(sorted(calls.items())),
        "slow_path_loops": {
            "count": len(nested),
            "instructions": len(in_nested),
            "local_memory": sum(1 for _, opcode, _, _ in in_nested if opcode in CLASSES["local_memory"]),
        },
        "try_waits": sum(map(is_try_wait, loop)),
    }
    philox = [i for i, (_, opcode, modifiers, operands) in enumerate(loop)
              if opcode in ("IMAD", "UIMAD") and modifiers.startswith(".WIDE.U32")
              and any(constant in operands.lower() for constant in PHILOX)]
    if philox:
        gaps = [b - a for a, b in zip(philox, philox[1:])]
        out["philox"] = {
            "products": len(philox),
            "uniform_products": sum(1 for i in philox if loop[i][1] == "UIMAD"),
            "first_position": philox[0],
            "span": philox[-1] - philox[0] + 1,
            "median_gap": sorted(gaps)[len(gaps) // 2] if gaps else 0,
            "largest_gap": max(gaps, default=0),
        }
    return out


def difference(a: dict, b: dict) -> dict:
    """b - a, class by class."""
    return {
        "loop_instructions": b["loop_instructions"] - a["loop_instructions"],
        **{name: b["loop"].get(name, 0) - a["loop"].get(name, 0) for name in sorted(set(a["loop"]) | set(b["loop"]))},
        "slow_path_loops": b["slow_path_loops"]["count"] - a["slow_path_loops"]["count"],
    }


def role_regions(instructions: list) -> list:
    """The two longest forward branches inside the step loop (source and
    target) that do not overlap, as the (start, end) spans they skip."""
    start, end = backward_branches(instructions)[0]
    skips = sorted(
        ((address + 16, to - 16) for address, opcode, _, operands in instructions
         if opcode == "BRA" and start <= address and (to := target(operands)) is not None and address < to <= end),
        key=lambda span: span[0] - span[1],
    )
    chosen = []
    for a, b in skips:
        if all(b < c or a > d for c, d in chosen):
            chosen.append((a, b))
        if len(chosen) == 2:
            return chosen
    raise RuntimeError(f"{len(chosen)} of 2 role regions found in the step loop")


def pair_census(instructions: list) -> dict:
    """A warp pair's step loop and its two role regions, named by role (the
    region with more FP32 arithmetic is the dynamics warp's). Each role's
    per-step count: the loop's minus the other role's region."""
    loop = census(instructions)
    regions = [census(instructions, span) for span in role_regions(instructions)]
    regions.sort(key=lambda region: -region["loop"].get("fp32_arith", 0))
    out = {"loop": loop}
    for role, own, other in (("dynamics_warp", regions[0], regions[1]), ("cost_warp", regions[1], regions[0])):
        out[role] = {
            "region_instructions": own["loop_instructions"],
            "region": own["loop"],
            "per_step_instructions": loop["loop_instructions"] - other["loop_instructions"],
            "per_step_fp32_arith": loop["loop"].get("fp32_arith", 0) - other["loop"].get("fp32_arith", 0),
        }
    return out


def report(sass: dict) -> dict:
    out = {}
    for key, (library, fragment, loops) in FUNCTIONS.items():
        functions = parse(sass[library])
        names = [name for name in functions if fragment in name]
        if len(names) != 1:
            raise RuntimeError(f"{key}: {len(names)} functions match {fragment} in {library}")
        instructions = functions[names[0]]
        out[key] = {"function": names[0],
                    **(census(instructions) if loops == 1 else pair_census(instructions))}
    out["kernel2_three_more_scenarios"] = difference(out["kernel2_rollout_x1"]["loop"],
                                                     out["kernel2_rollout_x4"]["loop"])
    return out


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        raise RuntimeError("cuobjdump not found: the census needs the CUDA toolkit")
    return found


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--dump", type=Path, default=None)
    parser.add_argument("--sass", type=Path, default=None)
    args = parser.parse_args()
    if args.sass:
        sass = {library: (args.sass / f"{library}.sass").read_text() for library in LIBRARIES}
    else:
        sys.path.insert(0, str(args.root.resolve()))
        from assistedmanipulation_tpu_torch.kernels import build

        build.build(tuple(LIBRARIES))
        sass = {
            library: subprocess.run([cuobjdump(), "-sass", str(build.library_path(library))],
                                    check=True, capture_output=True, text=True).stdout
            for library in LIBRARIES
        }
        if args.dump:
            args.dump.mkdir(parents=True, exist_ok=True)
            for library, text in sass.items():
                (args.dump / f"{library}.sass").write_text(text)
    print(json.dumps(report(sass)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
