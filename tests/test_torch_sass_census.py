"""scripts/torch_sass_census.py on small hand-written SASS listings: the
step loop is the longest backward branch, a nested backward branch is a
slow-path loop or, when it holds an mbarrier wait, a wait loop, calls are
told apart by their callee's body, the Philox products are found by their
multipliers, and a warp-specialised kernel's two step loops are found and
named by role. Needs no CUDA toolkit."""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_sass_census.py"
_SPEC = importlib.util.spec_from_file_location("torch_sass_census", _PATH)
census_script = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(census_script)


def _listing(name: str, body: list) -> str:
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, text in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;      /* 0x000000000000 */")
        lines.append("                                                        /* 0x000fe20000000800 */")
    return "\n".join(lines) + "\n"


# 0x00-0x10 prologue; 0x20-0xd0 the step loop (back edge at 0xd0) holding a
# nested loop 0x60-0x80; 0xe0 EXIT; 0xf0-0x120 a division slow path,
# 0x130-0x150 a sqrt slow path.
BODY = [
    "S2R R0, SR_TID.X",                              # 0x00
    "MOV R2, RZ",                                    # 0x10
    "FFMA R3, R4, R5, R6",                           # 0x20 loop start
    "IMAD.WIDE.U32 R8, R9, -0x2daee0ad, RZ",         # 0x30
    "IMAD.WIDE.U32 R10, R11, -0x326172a9, RZ",       # 0x40
    "@!P0 BRA 0x90",                                 # 0x50 forward
    "LDG.E.CONSTANT R12, desc[UR4][R6.64]",          # 0x60 nested loop
    "STL [R1], R12",                                 # 0x70
    "@P0 BRA 0x60",                                  # 0x80 nested back edge
    "MUFU.RSQ R13, R14",                             # 0x90
    "CALL.REL.NOINC 0xf0",                           # 0xa0
    "CALL.REL.NOINC 0x130",                          # 0xb0
    "FMUL R15, R16, R17",                            # 0xc0
    "@P1 BRA 0x20",                                  # 0xd0 loop back edge
    "EXIT",                                          # 0xe0
    "MUFU.RCP R20, R21",                             # 0xf0 division
    "FFMA.RZ R22, R23, R24, R25",                    # 0x100
    "FFMA R26, R27, R28, R29",                       # 0x110
    "RET.REL.NODEC R30 0x0",                         # 0x120
    "MUFU.RSQ R31, R32",                             # 0x130 sqrt
    "FFMA R33, R34, R35, R36",                       # 0x140
    "RET.REL.NODEC R37 0x0",                         # 0x150
]


def test_census_finds_the_step_loop_and_classifies_it():
    functions = census_script.parse(_listing("_Z6kernelv", BODY))
    out = census_script.census(functions["_Z6kernelv"])
    assert out["function_instructions"] == len(BODY)
    assert out["loop_instructions"] == 12  # 0x20..0xd0
    assert out["loop"] == {
        "call": 2, "control": 3, "fp32_arith": 2, "integer": 2, "local_memory": 1, "memory": 1, "mufu": 1,
    }
    assert out["fp32_arith_by_opcode"] == {"FFMA": 1, "FMUL": 1}
    assert out["slow_path_calls"] == {"division": 1, "sqrt": 1}
    assert out["slow_path_loops"] == {"count": 1, "instructions": 3, "local_memory": 1}
    assert out["philox"]["products"] == 2 and out["philox"]["span"] == 2


def test_census_difference_and_missing_loop():
    functions = census_script.parse(_listing("_Z1av", BODY) + _listing("_Z1bv", BODY[:2] + ["EXIT"]))
    a = census_script.census(functions["_Z1av"])
    assert census_script.difference(a, a)["loop_instructions"] == 0
    with pytest.raises(RuntimeError, match="step loop"):
        census_script.census(functions["_Z1bv"])


# A pair kernel: 0x00-0x20 the table-load loop; the step loop 0x30-0x100
# (back edge at 0x100) with a try-wait at 0x40 that retries out of line
# (0x120-0x150, back into the loop at 0x60); the cost region 0x70-0x90 (an
# FFMA and an FADD), which the dynamics warp jumps over from 0x60, and the
# dynamics region 0xb0-0xe0 (two FFMA and an FMUL), which the cost warp
# jumps over from 0x90 and 0xa0.
PAIR = [
    "LDG.E R2, desc[UR4][R4.64]",                    # 0x00 table load
    "STS [R6], R2",                                  # 0x10
    "@P0 BRA 0x0",                                   # 0x20 table-load back edge
    "FFMA R3, R4, R5, R6",                           # 0x30 step loop (shared FK)
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R7], R8",   # 0x40
    "@!P1 BRA 0x120",                                # 0x50 to the retry
    "@P2 BRA 0xa0",                                  # 0x60 the dynamics warp skips the cost region
    "FFMA R4, R5, R6, R7",                           # 0x70 cost region
    "FADD R5, R6, R7",                               # 0x80
    "BRA 0xf0",                                      # 0x90
    "@!P2 BRA 0xf0",                                 # 0xa0 the cost warp skips the dynamics region
    "FFMA R10, R11, R12, R13",                       # 0xb0 dynamics region
    "FMUL R14, R15, R16",                            # 0xc0
    "FFMA R17, R18, R19, R20",                       # 0xd0
    "SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R9], RZ",        # 0xe0
    "IADD3 R1, R1, 0x1, RZ",                         # 0xf0
    "@P3 BRA 0x30",                                  # 0x100 step loop back edge
    "EXIT",                                          # 0x110
    "YIELD",                                         # 0x120 out-of-line retry
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R7], R8",   # 0x130
    "@!P1 BRA 0x120",                                # 0x140
    "BRA 0x60",                                      # 0x150 back into the loop
]


def test_pair_census_finds_the_loop_and_one_region_per_role():
    functions = census_script.parse(_listing("_Z26pair_sample_rollout_kernelv", PAIR))
    instructions = functions["_Z26pair_sample_rollout_kernelv"]
    assert census_script.backward_branches(instructions) == [(0x30, 0x100), (0x0, 0x20)]
    # The cost region's own jump over the dynamics region (0x90 -> 0xf0)
    # skips 0xa0-0xe0: the dynamics region with its entry branch.
    assert census_script.role_regions(instructions) == [(0xa0, 0xe0), (0x70, 0x90)]
    out = census_script.pair_census(instructions)
    assert out["loop"]["loop_instructions"] == 14 and out["loop"]["try_waits"] == 1
    assert out["loop"]["loop"]["mbarrier"] == 2 and out["loop"]["slow_path_loops"]["count"] == 0
    dynamics, cost = out["dynamics_warp"], out["cost_warp"]
    assert dynamics["region_instructions"] == 5 and dynamics["region"]["fp32_arith"] == 3
    assert cost["region_instructions"] == 3 and cost["region"]["fp32_arith"] == 2
    assert dynamics["per_step_instructions"] == 11 and cost["per_step_instructions"] == 9
    assert dynamics["per_step_fp32_arith"] == 4 and cost["per_step_fp32_arith"] == 3
