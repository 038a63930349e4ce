"""The readers of ``cuobjdump`` output in :mod:`zerog_tpu_torch.bench.sass`,
on the CPU: resource usage by kernel, a kernel's innermost loop in both
forms of branch target (a label, as CUDA 12's ``cuobjdump`` prints it, or
an address), and the IMAD-pipe slots of its opcodes (``IMAD.WIDE`` two,
every other IMAD one). The samples are in the tool's layout, cut short."""

import pytest

from zerog_tpu_torch.bench import sass

RES_USAGE = """
Resource usage:
 Common:
  GLOBAL:0
 Function _Z18field_chain_kernelILi1EEvPKjS1_Pjli:
  REG:40 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:388 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z27scan_bisect_mul_smem_kernelPKjPjlli:
  REG:80 STACK:0 SHARED:8192 LOCAL:0 CONSTANT[0]:392 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z26scan_bisect_mul_reg_kernelILi4EEvPKjPjll:
  REG:152 STACK:16 SHARED:0 LOCAL:8 CONSTANT[0]:384 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

LOOP = [
    "IMAD.WIDE.U32 R4, R2, R3, RZ", "IMAD.HI.U32 R6, R2, R3, RZ",
    "IMAD.X R7, R2, R3, R6, P0", "IMAD.MOV.U32 R8, RZ, RZ, R4",
    "IADD3 R9, P1, R4, R5, RZ", "IMAD R10, R4, R5, R6",
    "IMAD.IADD R11, R4, 0x1, R5", "IMAD.SHL.U32 R12, R4, 0x2, RZ",
    "IMAD.WIDE.U32.X R14, P2, R2, R3, R14, P1", "ISETP.NE.AND P0, PT, R13, RZ, PT",
]


def _sass(labels: bool) -> str:
    """A kernel with a branch forward over an outer loop that holds the
    inner LOOP, and the end's branch to itself."""
    lines = ["\tcode for sm_90a",
             "\t\tFunction : _Z18field_chain_kernelILi1EEvPKjS1_Pjli",
             '\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
    addr = 0

    def put(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"          /* 0x000fe40000000800 */")
        lines.append("                                                  "
                     "/* 0x000fe40000000800 */")
        addr += 16
        return addr - 16

    def target(label, at):
        return f"`({label})" if labels else hex(at)

    put("LDC R1, c[0x0][0x28]")
    put(f"@!P0 BRA {target('.L_x_0', 0x100 + 16 * len(LOOP))}")
    lines.append(".L_x_2:")
    outer = put("MOV R2, R3")
    lines.append(".L_x_1:")
    inner = None
    for i, text in enumerate(LOOP):
        a = put(text)
        inner = a if i == 0 else inner
    put(f"@P0 BRA {target('.L_x_1', inner)}")
    put(f"@P1 BRA {target('.L_x_2', outer)}")
    lines.append(".L_x_0:")
    end = put("EXIT")
    lines.append(".L_x_3:")
    put(f"BRA {target('.L_x_3', end + 16)}")
    return "\n".join(lines)


def test_parse_res_usage():
    use = sass.parse_res_usage(RES_USAGE)
    assert use["field_chain_kernel<1>"] == dict(registers=40, shared=0, stack=0,
                                                local=0)
    assert use["scan_bisect_mul_smem_kernel"]["shared"] == 8192
    assert use["scan_bisect_mul_reg_kernel<4>"] == dict(registers=152, shared=0,
                                                        stack=16, local=8)


@pytest.mark.parametrize("labels", [True, False], ids=["label", "address"])
def test_loop_body_is_the_innermost_loop(labels):
    instrs = sass.parse_sass(_sass(labels))["field_chain_kernel<1>"]
    body = sass.loop_body(instrs)
    assert [t for _, t in body[:-1]] == LOOP
    assert body[-1][1].startswith("BRA ")
    assert int(body[-1][1].split()[-1], 16) == body[0][0]


def test_imad_slots_by_class():
    counts, slots = sass.imad_slots([(0, t) for t in LOOP])
    assert counts == {"IMAD": 1, "IMAD.HI": 1, "IMAD.IADD": 1, "IMAD.MOV": 1,
                      "IMAD.SHL": 1, "IMAD.WIDE": 2, "IMAD.X": 1}
    assert slots == 6 + 2 * 2


def test_a_kernel_without_a_loop_raises():
    text = "\n".join(["\t\tFunction : _Z1kv",
                      "        /*0000*/                   EXIT ;",
                      ".L_x_0:",
                      "        /*0010*/                   BRA `(.L_x_0);"])
    with pytest.raises(ValueError, match="no loop"):
        sass.loop_body(sass.parse_sass(text)["k"])
