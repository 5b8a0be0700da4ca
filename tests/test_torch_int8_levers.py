"""scripts/int8_levers.py on the CPU: every lever patches lines that its
sources hold exactly once, and the ptxas parser reads the int8 core's
instantiations through ``quant.gemm_instantiation`` (the script itself
runs only on the card)."""

import pytest

from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.scripts import int8_levers
from algonauts2025_tpu_torch.scripts import kernel_tools as kt


@pytest.mark.parametrize("lever", sorted(int8_levers.LEVERS))
def test_lever_lines_occur_once_in_the_sources(lever):
    for file, old, new in int8_levers.LEVERS[lever]:
        assert file in int8_levers.FILES and old != new
        assert (_cuda.CSRC / file).read_text().count(old) == 1, (file, old)


def test_every_lever_applies_and_changes_only_its_files(tmp_path):
    folders = kt.write_builds(int8_levers.FAMILY, {}, tmp_path)
    assert list(folders) == list(int8_levers.LEVERS)
    built = {file: (folders["as built"] / file).read_text() for file in int8_levers.FILES}
    assert built == {file: (_cuda.CSRC / file).read_text() for file in int8_levers.FILES}
    for lever, patches in int8_levers.LEVERS.items():
        changed = {file for file in int8_levers.FILES if (folders[lever] / file).read_text() != built[file]}
        assert changed == {file for file, _, _ in patches}, lever


def test_baseline_directory_is_read_whole(tmp_path):
    parent = tmp_path / "parent"
    parent.mkdir()
    for file in int8_levers.FILES:
        (parent / file).write_text(f"// {file}\n")
    baselines = kt._baselines(int8_levers.FAMILY, [f"parent={parent}"])
    folders = kt.write_builds(int8_levers.FAMILY, baselines, tmp_path / "builds")
    assert {file: (folders["parent"] / file).read_text() for file in int8_levers.FILES} == {
        file: f"// {file}\n" for file in int8_levers.FILES}


def test_ptxas_report_is_read_per_instantiation():
    report = """ptxas info    : Compiling entry function '_ZN4i8wg15quantize_kernelIfLi8EEEvPKT_PaPKfx' for 'sm_90a'
ptxas info    : Used 31 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN4i8wg11gemm_kernelIN12_GLOBAL__N_114StoreGeluQuantENS_8PingPongEEEvNS_6ParamsEPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 5 barriers
"""
    build = kt.Build(_cuda.BUILD_DIR / "libint8_mlp.so", report, 0)
    labelled, remarks, ok = kt.gate(int8_levers.FAMILY, "parent", {"int8_mlp": build})
    assert labelled == {"int8_mlp": {"StoreGeluQuant, PingPong": {"spills": 0, "registers": 168}}}
    assert remarks == [] and ok


def test_lever_builds_launch_with_their_schedules_registers():
    """A lever build is launched only where ptxas gave each instantiation the
    registers its schedule's setmaxnreg split assumes."""
    from algonauts2025_tpu_torch.ops import quant

    rule = int8_levers.FAMILY.launch_regs
    for gemm in quant.INT8_GEMMS:
        block = quant.gemm_block(gemm)
        assert rule("as built", ("StoreGeluQuant", block["schedule"])) == block["launch_regs"]
    assert rule("as built", ("StoreGeluQuant", "PingPongPairs")) == 96
    assert rule("fc2 PingPong (128 x 128 tiles)", ("StoreDequantIfLi1EE", "Cooperative")) == 168
