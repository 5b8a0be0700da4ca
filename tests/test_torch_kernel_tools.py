"""scripts/kernel_tools.py on the CPU, over text recorded from the kernels'
build on an H100 (``tests/fixtures/kernels``: each library's ``-Xptxas -v``
report, and its ``cuobjdump -sass`` cut down to each kernel's name and its
warpgroup-MMA and USETMAXREG lines): the decoders, the parsers, the
patched build, chip_smoke.py's SASS and ptxas gate, which must stop a
build whose consumers would hang before any launch, and the lever scripts'
launch gate."""

import dataclasses
import json
import re
import subprocess
from pathlib import Path
from unittest import mock

import pytest
import torch

import chip_smoke
from algonauts2025_tpu_torch.ops import _cuda, quant
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.scripts import flash_levers, int8_levers
from algonauts2025_tpu_torch.scripts import kernel_tools as kt

RECORDED = Path(__file__).parent / "fixtures" / "kernels"
LIBRARIES = ("flash_attention", "w8a8", "int8_mlp")
TC_NAMES = re.findall(r"Compiling entry function '(\w*flash_tc_kernel\w*)'",
                      (RECORDED / "flash_attention.ptxas.txt").read_text())


def _cuobjdump(sass: dict[str, str]):
    """Stand-ins for ``cuobjdump -sass`` of ``lib<name>.so`` giving ``sass[name]``."""
    def run(cmd, **kwargs):
        name = re.match(r"lib(\w+)\.so", Path(cmd[-1]).name).group(1)
        return subprocess.CompletedProcess(cmd, 0, stdout=sass[name])
    return mock.patch.object(kt.subprocess, "run", run), mock.patch.object(kt._cuda, "cuda_tool", lambda name: name)


def _recorded(kind: str) -> dict[str, str]:
    return {lib: (RECORDED / f"{lib}.{kind}.txt").read_text() for lib in LIBRARIES}


def _check_sass(reports: dict[str, str], sass: dict[str, str]) -> None:
    run, tool = _cuobjdump(sass)
    with run, tool, mock.patch.object(chip_smoke, "ptxas_report", reports.__getitem__):
        chip_smoke.check_sass(Path("libflash_attention.so"), {"w8a8": Path("libw8a8.so"),
                                                             "int8_mlp": Path("libint8_mlp.so")})


@pytest.mark.parametrize("name", TC_NAMES)
def test_tc_instantiation_reads_the_six_bf16_instantiations(name):
    """Each recorded bf16 instantiation's (head dim, masked, bf16 scores),
    its template arguments, among the six that launch_typed instantiates."""
    head_dim, masked, bf16_scores = re.search(r"flash_tc_kernelILi(\d+)ELb([01])ELb([01])E", name).groups()
    assert tf.tc_instantiation(name) == (int(head_dim), int(masked), int(bf16_scores))
    assert tf.tc_instantiation(name) in tf.TC_INSTANTIATIONS
    assert sorted(map(tf.tc_instantiation, TC_NAMES)) == sorted(tf.TC_INSTANTIATIONS)


@pytest.mark.parametrize("library", LIBRARIES)
def test_ptxas_kernels_reads_a_recorded_report(library):
    """Registers and spills of every kernel of a recorded report: the bf16
    flash instantiations hold ``tc_block``'s launch registers and the int8
    core's GEMMs ``gemm_block``'s, none spills, and ptxas made no remark."""
    report = (RECORDED / f"{library}.ptxas.txt").read_text()
    kernels = kt.ptxas_kernels(report)
    assert kernels and all(info["spills"] == 0 and info["registers"] > 0 for info in kernels.values())
    if library == "flash_attention":
        got = {tf.tc_instantiation(k): v["registers"] for k, v in kernels.items() if "flash_tc_kernel" in k}
        assert got == {key: tf.tc_block(key[0])["launch_regs"] for key in tf.TC_INSTANTIATIONS}
    else:
        got = {quant.gemm_instantiation(k): v["registers"] for k, v in kernels.items() if "gemm_kernel" in k}
        assert got == {(epilogue, quant.INT8_GEMMS[gemm]): quant.gemm_block(gemm)["launch_regs"]
                       for epilogue, gemm in quant.INT8_EPILOGUES[library].items()}
        assert any("quantize_kernel" in k for k in kernels)
    assert kt.ptxas_remarks(report) == []


@pytest.mark.parametrize("old,bad", [("c;", True), ("b;", True), ("a;", False)], ids=["missing", "doubled", "once"])
def test_write_patched_reports_a_missing_or_doubled_line(old, bad, tmp_path):
    """A patch whose text is not in its file exactly once comes back to the
    caller, and nothing is written; otherwise the patched copy is."""
    (tmp_path / "k.cu").write_text("a;\nb;\nb;\n")
    patch = ("k.cu", old, "x;")
    folder = tmp_path / "out"
    assert kt.write_patched({"k.cu": tmp_path / "k.cu"}, [patch], folder) == ([patch] if bad else [])
    assert (folder / "k.cu").exists() != bad
    if not bad:
        assert (folder / "k.cu").read_text() == "x;\nb;\nb;\n"


@pytest.mark.parametrize("lever", sorted(flash_levers.LEVERS))
def test_flash_lever_lines_occur_once_in_the_source(lever):
    for file, old, new in flash_levers.LEVERS[lever]:
        assert file == "flash_attention.cu" and old != new
        assert (_cuda.CSRC / file).read_text().count(old) == 1, old


def test_no_turns_lever_takes_out_every_turn(tmp_path):
    """The turn lever's patches, each of one place, take out every turn of
    the consumer warpgroups and nothing else."""
    source = _cuda.CSRC / "flash_attention.cu"
    lever = "no turns (the warpgroups issue their products freely)"
    assert kt.write_patched({source.name: source}, flash_levers.LEVERS[lever], tmp_path) == []
    want = source.read_text()
    for call in ("bar_sync(kTurn + wg, 256);", "bar_arrive(next_turn, 256);", "bar_arrive(kTurn, 256);"):
        want = want.replace(call, "{}")
    assert (tmp_path / source.name).read_text() == want


def test_check_sass_passes_the_recorded_builds():
    _check_sass(_recorded("ptxas"), _recorded("sass"))


@pytest.mark.parametrize("library,old,new", [
    ("flash_attention", "Used 168 registers", "Used 160 registers"),
    ("int8_mlp", "Used 96 registers", "Used 104 registers"),
    ("w8a8", "0 bytes spill stores", "8 bytes spill stores"),
    ("flash_attention", "ptxas info    : Compile time",
     "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized\nptxas info"
     "    : Compile time"),
], ids=["flash_registers", "fc1_registers", "w8a8_spill", "serialised_wgmma"])
def test_check_sass_stops_a_build_before_any_launch(library, old, new):
    """Registers at launch other than the block's (a setmaxnreg split that
    would hang), a spill or a serialised wgmma in any instantiation stops
    chip_smoke.py before a launch."""
    reports = _recorded("ptxas")
    reports[library] = reports[library].replace(old, new, 1)
    with pytest.raises(SystemExit):
        _check_sass(reports, _recorded("sass"))


@pytest.mark.parametrize("library,op", [("flash_attention", "USETMAXREG"), ("w8a8", "IGMMA")])
def test_check_sass_needs_every_instantiations_mma_and_setmaxnreg(library, op):
    sass = _recorded("sass")
    sass[library] = "\n".join(line for line in sass[library].splitlines() if op not in line)
    with pytest.raises(SystemExit, match=op):
        _check_sass(_recorded("ptxas"), sass)


def test_sass_functions_reads_every_kernel():
    run, tool = _cuobjdump(_recorded("sass"))
    with run, tool:
        functions = kt.sass_functions(Path("libint8_mlp.so"))
    ops = {quant.gemm_instantiation(k): kt.sass_ops(v, ("IGMMA", "USETMAXREG"))
           for k, v in functions.items() if "gemm_kernel" in k}
    assert ops == {key: {"IGMMA": 4, "USETMAXREG": 2} for key in (
        ("StoreGeluQuant", "PingPongPairs"), ("StoreDequantIfLi1EE", "Cooperative"),
        ("StoreDequantI13__nv_bfloat16Li1EE", "Cooperative"))}
    assert sum("quantize_kernel" in k for k in functions) == 4


@pytest.mark.parametrize("family,name,want", [
    (flash_levers.FAMILY, "as built", True),
    (flash_levers.FAMILY, flash_levers.TWO_WARPGROUPS, False),
    (flash_levers.FAMILY, "parent", True),
    (int8_levers.FAMILY, "as built", True),
    (int8_levers.FAMILY, "fc1 PingPong (one warpgroup a 128 x 128 tile)", True),
])
def test_lever_gate_holds_levers_to_their_launch_registers(family, name, want):
    """On the recorded reports: the build as built launches, a lever whose
    split assumes other registers than ptxas gave does not, a baseline is not
    held to a lever's registers, and an int8 lever is held to the registers
    of the schedule ptxas reports."""
    reports = _recorded("ptxas")
    builds = {lib: kt.Build(Path(f"lib{lib}.so"), reports[lib], 0) for lib in family.libraries}
    assert kt.gate(family, name, builds)[2] is want


def test_lever_gate_wants_every_instantiation_and_nvcc_exit_0():
    report = _recorded("ptxas")["flash_attention"]
    first = re.search(r"Compiling entry function '\w+tc15flash_tc_kernel", report).start()
    fewer = report[:first] + report[report.index("Compiling entry function", first + 1):]
    library = Path("libflash_attention.so")
    assert not kt.gate(flash_levers.FAMILY, "as built", {"flash_attention": kt.Build(library, fewer, 0)})[2]
    assert not kt.gate(flash_levers.FAMILY, "as built", {"flash_attention": kt.Build(library, report, 1)})[2]


def test_mlp_case_takes_a_given_x_in_place_of_its_draw():
    """int8_levers.py draws row 7's x as row 6's and hands it over; the rest
    of row 7's arguments are those chip_smoke.py draws after its own x."""
    drawn = kt.mlp_case(8, 128, 256, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 128), generator=gen).to(torch.bfloat16)
    given = kt.mlp_case(8, 128, 256, gen, x=x)
    for a, b in zip([*drawn[0], *drawn[1:]], [*given[0], *given[1:]]):
        assert torch.equal(a, b)
    assert given[2] > 0


@pytest.mark.parametrize("spec", ["parent", "parent={missing}", "as built={csrc}"])
def test_int8_levers_refuse_a_bad_baseline(spec, tmp_path):
    """--baseline takes NAME=DIR of a directory holding the three sources,
    under a name that is not a lever's; the check comes before any build."""
    spec = spec.format(missing=tmp_path, csrc=_cuda.CSRC)
    with pytest.raises(SystemExit, match="--baseline takes NAME=DIR"):
        int8_levers.main(["--baseline", spec])


#: the keys of the lever scripts' JSON (top level, and a launched build's)
#: as the card's runs of them write it
JSON_KEYS = {
    "flash_levers": ({"card", "rounds", "levers", "sdpa_ms", "sass_ops"},
                     {"spill_bytes", "ptxas_remarks", "launched", "ms", "rel_l2", "median_ms"}),
    "int8_levers": ({"card", "rounds", "builds", "sass_ops"},
                    {"ptxas", "ptxas_remarks", "launched", "ms", "parts_ms", "errors", "median_ms"}),
}


@pytest.mark.parametrize("module", [flash_levers, int8_levers], ids=lambda m: m.FAMILY.script)
def test_lever_study_writes_the_scripts_json(module, tmp_path):
    """The whole lever program on the CPU: every build stands for the
    recorded one, the rows are CPU stand-ins and the timer a constant; the
    JSON keeps each script's keys, and each lever is held to its own launch
    registers."""
    family = module.FAMILY
    reports = _recorded("ptxas")
    calls = []

    def setup():
        rows = {"row a": kt.Row(lambda: torch.ones(3), 2, lambda out: kt.rel_l2(out, torch.ones(3)))}
        top = {"sdpa_ms": {"row 4": 1.0}} if family.builds_key == "levers" else {}
        return rows, top, (lambda: {"part": 0.5}) if family.builds_key == "builds" else None

    def finish(started):
        calls.append(sorted(started))
        return {(name, lib): kt.Build(library, reports[lib], 0) for (name, lib), library in started.items()}

    run, tool = _cuobjdump(_recorded("sass"))
    with run, tool, mock.patch.object(kt.torch.cuda, "is_available", lambda: True), \
            mock.patch.object(kt._cuda, "BUILD_DIR", tmp_path / "_build"), \
            mock.patch.object(kt, "start_builds", lambda jobs: {key: lib for key, (_, lib) in jobs.items()}), \
            mock.patch.object(kt, "finish_builds", finish), mock.patch.object(kt, "stand_in", lambda libs: None), \
            mock.patch.object(kt, "card_line", lambda: "a card"), \
            mock.patch.object(kt, "time_ms", lambda fn, iters: float(iters)):
        result = kt.lever_study(dataclasses.replace(family, setup=setup), module.__doc__,
                                ["--rounds", "3", "--out", str(tmp_path)])
    top_keys, build_keys = JSON_KEYS[family.script]
    assert set(result) == top_keys and result == json.loads((tmp_path / f"{family.script}.json").read_text())
    assert list(result[family.builds_key]) == list(family.levers) and len(calls) == 1
    # every build stands for the as-built one, so only the lever whose split
    # assumes other registers stays unlaunched
    unlaunched = {flash_levers.TWO_WARPGROUPS} if family is flash_levers.FAMILY else set()
    for name, entry in result[family.builds_key].items():
        assert entry["launched"] is (name not in unlaunched) and entry["ptxas_remarks"] == []
        assert set(entry) == (build_keys if entry["launched"] else build_keys - {"median_ms"})
        if entry["launched"]:
            assert entry["median_ms"]["row a"] == 2.0 and len(entry["ms"]["row a"]) == 3
    sass = result["sass_ops"] if family.builds_key == "builds" else {"flash_attention": result["sass_ops"]}
    assert set(sass) == set(family.libraries) and all(sass.values())
