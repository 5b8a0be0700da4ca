"""scripts/int8_levers.py on the CPU: every lever patches lines that its
sources hold exactly once, and the ptxas and SASS parsers read the int8
core's instantiations (the script itself runs only on the card)."""

import pytest

from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.scripts import int8_levers


@pytest.mark.parametrize("lever", sorted(int8_levers.LEVERS))
def test_lever_lines_occur_once_in_the_sources(lever):
    for file, old, new in int8_levers.LEVERS[lever]:
        assert file in int8_levers.FILES and old != new
        assert (_cuda.CSRC / file).read_text().count(old) == 1, (file, old)


def test_every_lever_applies_and_changes_only_its_files():
    texts = int8_levers._sources({})
    assert list(texts) == list(int8_levers.LEVERS)
    built = texts["as built"]
    for lever, patches in int8_levers.LEVERS.items():
        changed = {file for file in int8_levers.FILES if texts[lever][file] != built[file]}
        assert changed == {file for file, _, _ in patches}, lever


def test_baseline_directory_is_read_whole(tmp_path):
    for file in int8_levers.FILES:
        (tmp_path / file).write_text(f"// {file}\n")
    texts = int8_levers._sources({"parent": tmp_path})
    assert texts["parent"] == {file: f"// {file}\n" for file in int8_levers.FILES}


@pytest.mark.parametrize("mangled,want", [
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantI13__nv_bfloat16Li0EEENS_8PingPongEEEvNS_6ParamsEPKf",
     "StoreDequantI13__nv_bfloat16Li0EE, PingPong"),
    ("_ZN4i8wg11gemm_kernelIN12_GLOBAL__N_114StoreGeluQuantENS_11CooperativeEEEvNS_6ParamsEPKf",
     "StoreGeluQuant, Cooperative"),
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantIfLi1EEEEEvNS_6ParamsEPKf", "StoreDequantIfLi1EE, -"),
    ("_ZN4i8wg11gemm_kernelINS_16StoreDequantRopeINS_12StoreDequantI13__nv_bfloat16Li0EEEEENS_8PingPongEEEvNS_6Params"
     "ENT_4ArgsE", "StoreDequantRope, PingPong"),
])
def test_instantiation_names(mangled, want):
    assert int8_levers._instantiation(mangled) == want


def test_ptxas_report_is_read_per_instantiation():
    report = """ptxas info    : Compiling entry function '_ZN4i8wg15quantize_kernelIfLi8EEEvPKT_PaPKfx' for 'sm_90a'
ptxas info    : Used 31 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN4i8wg11gemm_kernelIN12_GLOBAL__N_114StoreGeluQuantENS_8PingPongEEEvNS_6ParamsEPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 5 barriers
"""
    assert int8_levers._ptxas(report) == {"StoreGeluQuant, PingPong": {"spills": 0, "registers": 168}}


def test_lever_builds_launch_with_their_schedules_registers():
    """A lever build is launched only where ptxas gave each instantiation the
    registers its schedule's setmaxnreg split assumes."""
    from algonauts2025_tpu_torch.ops import quant

    for gemm in quant.INT8_GEMMS:
        block = quant.gemm_block(gemm)
        assert int8_levers._launch_regs(f"StoreGeluQuant, {block['schedule']}") == block["launch_regs"]
    assert int8_levers._launch_regs("StoreGeluQuant, PingPongPairs") == 96
    assert int8_levers._launch_regs("StoreDequantIfLi1EE, Cooperative") == 168
