#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit; build every kernel of
   ``algonauts2025_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge shapes (the trunk attention's autograd
   gradients too); time the kernel, the plain version and one library
   call that computes the same function (a yardstick the port never
   calls): ``scaled_dot_product_attention`` for the attention kernels,
   ``torch._int_mm`` plus the elementwise quant passes for the int8 ones,
   with the K-major weight copy seen as (K, N) (and ``torch._int_mm``
   alone in both weight layouts, the yardstick of their GEMMs).  The
   trunk attention also runs a layout that takes its one-element loads.
   The flash kernels run bf16 on the tensor cores and fp32 on the CUDA
   cores: each fp32 edge case has a bf16 twin, and the SASS of every bf16
   instantiation must hold ``HGMMA`` and the register reallocation
   (``USETMAXREG``), with no spills and no serialised wgmma in ptxas's
   report (before any launch); that of every GEMM of the two int8
   kernels ``IGMMA`` and ``USETMAXREG``, with no spills, the launch
   registers of ``quant.gemm_block`` and the schedule ``quant.INT8_GEMMS``
   names; the w8a8 kernel must refuse an unaligned K without a launch, and
   its rotating entry (the query's and key's, with the V-JEPA rotary in the
   epilogue) must equal its plain version at ViT-G with the ViT-G tables,
   beside the plain epilogue's time.  The
   int8 kernels' quantize passes and GEMMs are timed apart under
   ``torch.profiler``, beside the bytes their tiles read from L2.  The
   flash rows' bounds count their exponentials at the MUFU's rate beside
   the operations and the bytes (every bound from the benchmark's frozen
   peak table, ``benchmark/common/peaks.py``).  Two mutants of the masked flash
   kernel, built from patched copies of its source under
   ``_build/mutants`` (one ignores the key lengths, one ignores
   ``causal``), must fail the same check.  The bench-only fast
   kernel with bf16 scores must differ from itself with fp32 scores, and
   the packed wrapper must refuse d != 64 and an odd head count.  The
   relative-key kernel (w2v-BERT's attention) runs at the audio cell's
   shapes within ``RELKEY_REL`` of its plain version, timed at
   T = 3000 beside its bound and the plain version; its SASS must hold
   HGMMA and USETMAXREG with no spills at its block's launch registers,
   and two mutants (the probabilities rounded before they are normalised,
   the bias one distance off) must fail its check.  The six
   ``flash_tc_kernel`` instantiations must have the SASS whose digests
   ``tests/fixtures/kernels/flash_tc_kernel.sass.sha256`` records (an
   H100 build, recorded anew with every change to that kernel).
3. A small FmriEncoder trained on the card and on the CPU from the same
   weights must agree step by step; a small static-int8 V-JEPA2 backbone
   (1024 tokens, so every video kernel dispatches), a small fp32 Llama
   (512 tokens, right-padded, so the masked flash kernel dispatches) and a
   small bf16 w2v-BERT at head dim 64 (48 kHz chunks through the bucketed,
   pad-masked audio path, the relative-key kernel on the card) must give the
   same features on the card as on the CPU from the same weights.  Host batches of the flagship's shapes go through
   ``data.prefetch_to_device`` (the Experiment's feed: a producer thread,
   pinned ``non_blocking`` copies) and must arrive on the card unchanged;
   ``to_device`` must leave them where they are, and an early stop must end
   the producer thread.
4. The trunk's main path at full width: ``BrainTrainer`` on the flagship
   FmriEncoder configured as ``bench.py``'s ``bench_train`` (0.94 B
   params, batch 16 x 298 steps, remat, InfoNCE, bf16-mu Adam, OneCycle),
   with random weights from a seed: ``init_state``, train steps,
   ``evaluate`` with the default grid's three metrics, ``predict``; then
   one more train step under ``torch.profiler`` (top kernels and the
   device-busy share).
5. The video path at full ViT-G width and depth (40 layers, 1408 wide,
   8192 tokens a window), static int8 as the production feature runs it:
   seeded float weights quantized per layer, calibration on the seeded
   input, 10 seeded uint8 windows through ``encode_window_stream`` in
   batches of 4, then ``aggregate_layers`` down to the trunk's video input.
   One batch is encoded again under ``torch.profiler``; the first batch is
   encoded again with every kernel of the backbone swapped for its plain
   version on the card, and the token-pooled features of the two must
   agree.
6. The text path at full Llama-3.2-3B width and depth (28 layers, 3072
   wide, 24 query heads over 8 kv heads of 128, bf16), seeded weights at
   the HF init scale, the hash tokenizer: a seeded 1,280-word transcript
   with rolling contexts capped at 1,024 words through
   ``encode_word_stream`` (one 1,024-word chain in 16 forwards, then 32
   padded (8, 1024) batches), then ``aggregate_layers`` down to the
   trunk's text input.  One chain chunk and one batch are encoded again
   with the flash kernel swapped for its plain version, and the pooled
   features of the two must agree; so must the batch's through the same
   weights in fp32.

7. The attention bench path: ``algonauts2025_tpu_torch.scripts.bench_attn``
   with ``all`` at its (4, 22, 8192, 64) bf16 shape: every variant timed,
   then held against ``fast``; the launches must be those the bench
   reckons.
8. The audio path at full w2v-BERT 2.0 width and depth (24 layers, 1024
   wide, 16 heads of 64, bf16), seeded weights at the HF init scale: a
   seeded 48 kHz stereo speech-like signal cut into five chunks of 30-60
   s, each through ``mono_zscore`` and ``encode_sound_stream`` (resample,
   5 s buckets, masked mel, conformer, 2 Hz frames), then
   ``aggregate_layers`` down to the trunk's audio input; the attention of
   each layer launches the relative-key kernel once, and nothing else
   launches.  One chunk is encoded again at its exact length, and the two
   must agree.

9. The port's ``Experiment(**cfg).run()`` on the card, ``cfg`` being
   ``grids/defaults.py``'s with ``accelerator="cuda"``:
   - the text branch (``LLAMA3p2`` at full Llama-3.2-3B width, seeded
     weights through ``set_backbone``, layers [0.5, 0.75, 1.0] group_mean)
     on the flagship trunk with InfoNCE on text, batch 16, one epoch, over
     a synthetic study written by ``make_synthetic_study``: the four
     release subjects, 1000 parcels, 4 train episodes of 300 s.  It prints
     the seconds by stage, the seconds of a train step inside the
     Experiment beside phase 4's, the peak and the launches, and requires
     metrics.csv, pearson.npy, last.ckpt and submission.zip with finite
     numbers.  A rerun from the same folders must compute no feature and
     launch the text kernel no time;
   - a small Experiment (tiny trunk, tiny text backbone, the same initial
     weights) on the card and on the CPU: the per-epoch train losses agree;
   - the pydantic ``Wav2VecBert`` at full w2v-BERT 2.0 width over ``Sound``
     events of a 48 kHz stereo wav written by ``io/wav`` (phase 8's chunk
     durations): each chunk's features agree with ``encode_sound_stream``
     on the same samples within phase 8's limits, and a second feature
     over the same cache computes nothing;
   - the whole trimodal default (Llama-3.2-3B, w2v-BERT 2.0, ViT-G static
     int8, the flagship trunk with InfoNCE on video) over a synthetic study
     with video: the video kernels launch as reckoned, rows 1 and 2 launch.

10. The model soup, the profiled Experiment, ``save_attn_out``, the
    other optimizers and FmriMlp (``soup_path`` and the functions after it).
11. The parallel strategies (``parallel_path``): (a) ``init_distributed``
    over NCCL (a localhost rendezvous, world 1), ``get_mesh(n_devices=1)``
    and phase 4's trainer on it: its first 3 losses are phase 4's; (b) two
    processes on the one card joined by gloo (which takes CUDA tensors):
    dp2 and dp1 x tp2 on the flagship trunk, their losses held to (a)'s,
    then in the dp1 x tp2 world Adafactor and LAMB (which reduce over
    whole parameters), 2 steps each, held to one process of each on the
    card; (c) phase 5's ViT-G with each window's 8192 tokens over 8 shards
    (ring attention) on phase 5's first window batch, against phase 5's
    features, rows 6 and 7 launching per shard and row 4 never; (d) phase
    6's Llama-3.2-3B in 4 pipeline stages, one (8, 1024) batch in 2
    microbatches, against the scanned forward, row 2 launching 28 times a
    microbatch.  The card is one H100: (c) and (d) call the backbone API
    over virtual shards and stages of cuda:0 (``LocalMesh``), since the
    features' options ask for as many cards.

``python3 chip_smoke.py --cards 4`` runs phase 11's parts over 4 cards of
one host instead (``cards_path``): the trainer in 4 NCCL processes, the
ring over 4 cards, the pipeline in 4 stages, one a card.

Before each main path (phases 4 to 9) every kernel's launch counter is
zeroed, and it is read just after.  The line before the last is the JSON
``kernels`` record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from algonauts2025_tpu_torch.config import ConfDict
from algonauts2025_tpu_torch.core.events import Sound
from algonauts2025_tpu_torch.data import SegmentData, SegmentDataset, prefetch_to_device, to_device
from algonauts2025_tpu_torch.data.synthetic import make_synthetic_study
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.experiment import data as experiment_data
from algonauts2025_tpu_torch.experiment.data import Data as ExperimentData
from algonauts2025_tpu_torch.features.audio import (
    TARGET_SR, TorchAudioBackbone, Wav2VecBert, encode_sound_stream, mono_zscore,
)
from algonauts2025_tpu_torch.features.text import (
    CHAIN_CHUNK, LLAMA3p2, HashTokenizer, TinyTextBackbone, TorchTextBackbone, _bucket_width,
    encode_word_stream,
)
from algonauts2025_tpu_torch.features.video import (
    VJEPA2, TorchVideoBackbone, _calibrated_static_model, encode_window_stream,
)
from algonauts2025_tpu_torch.grids import average_submissions, run_ensemble
from algonauts2025_tpu_torch.grids import run_grid as run_grid_cli
from algonauts2025_tpu_torch.grids.defaults import default_config
from algonauts2025_tpu_torch.io import wav as wavio
from algonauts2025_tpu_torch.models import FmriEncoderConfig, FmriMlpConfig
from algonauts2025_tpu_torch.models.backbones import llama, vjepa2
from algonauts2025_tpu_torch.models.backbones.llama import LLAMA_3P2_3B, LlamaBackbone, LlamaConfig
from algonauts2025_tpu_torch.models.backbones.vjepa2 import (
    VJEPA2_VITG, VJEPA2Backbone, VJEPA2Config, _QDense,
)
from algonauts2025_tpu_torch.models.backbones.wav2vec_bert import (
    W2V_BERT_2_0, Wav2VecBertBackbone, Wav2VecBertConfig,
)
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.ops import attention as attn
from algonauts2025_tpu_torch.ops import flash_attention as flash
from algonauts2025_tpu_torch.ops import quant
from algonauts2025_tpu_torch.ops.layer_agg import aggregate_layers
from algonauts2025_tpu_torch.ops.resample import resample_poly
from algonauts2025_tpu_torch.parallel import get_mesh, init_distributed, local_mesh, pipelined_llama_states
from algonauts2025_tpu_torch.scripts import bench_attn, kernel_tools
from algonauts2025_tpu_torch.scripts.kernel_tools import (
    VITG_D, VITG_F, VITG_M, kmajor, mlp_case, parts_ms, rel_l2, time_ms, w8a8_case,
)
from algonauts2025_tpu_torch.utils.profiling import step_summary
from algonauts2025_tpu_torch.training import (
    BrainTrainer, OptimConfig, TrainerConfig, build_loss, build_metric,
)
from benchmark.common.peaks import bound_s, peaks_for

SEED = 0
# (B, H, T, Dh) of the trunk's attention at the flagship: hidden 3072, 8 heads
FLAGSHIP = (16, 8, 298, 384)
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}

COUNTERS = (attn.launch_counts, flash.launch_counts, quant.launch_counts)


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for counts in COUNTERS:
        for key in counts:
            counts[key] = 0


def launch_counts() -> dict[str, int]:
    """Every kernel's launches since the last ``reset_counts``."""
    return {key: n for counts in COUNTERS for key, n in counts.items()}


def flash_bound(flops: float, nbytes: float, exps: float, peaks: dict[str, float]) -> tuple[float, str, str]:
    """A bf16 flash row's bound in ms (``bound_s`` with its exponentials),
    the term that binds as a kernel record names it (the ex2 are operations,
    of the MUFU), and the three terms for the log."""
    seconds, bound_by = bound_s(flops, nbytes, peaks["bfloat16"], peaks, exps)
    terms = (f"bound by {bound_by}: operations {1e3 * flops / peaks['bfloat16']:.4f} ms "
             f"({flops / 1e12:.4f} TFLOP), bytes {1e3 * nbytes / peaks['bytes']:.4f} ms ({nbytes / 1e6:.1f} MB), "
             f"exp {1e3 * exps / peaks['exp']:.4f} ms ({exps / 1e9:.4f} G ex2)")
    return 1e3 * seconds, "operations" if bound_by == "exp" else bound_by, terms


def kernel_record(name, source, replaces, err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by):
    return {"name": name, "route": "cuda", "source": f"algonauts2025_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs a CUDA card")
    line = kernel_tools.card_line()
    log(f"card: {line}")
    return line


def build_kernels() -> dict[str, Path]:
    """Build every source of csrc and, beside them, the MUTANTS and
    RELKEY_MUTANTS of the flash source, patched copies under _build/mutants
    (all nvcc processes at once); returns the mutants' libraries."""
    t0 = time.time()
    source, jobs = {"flash_attention.cu": _cuda.CSRC / "flash_attention.cu"}, {}
    patches = {**{name: [("flash_attention.cu", line, patched)] for name, (line, patched) in MUTANTS.items()},
               **RELKEY_MUTANTS}
    for name, patch in patches.items():
        folder = _cuda.BUILD_DIR / "mutants" / name
        if bad := kernel_tools.write_patched(source, patch, folder):
            raise SystemExit(f"mutant {name}: {[old for _, old, _ in bad]} not each once in flash_attention.cu")
        jobs[name] = (folder / "flash_attention.cu", folder / "libflash_attention.so")
    started = kernel_tools.start_builds(jobs)
    try:
        libs = _cuda.build_all()
    finally:
        mutants = kernel_tools.finish_builds(started)
    log(f"built {sorted(libs)} and mutants {sorted(mutants)} in {time.time() - t0:.1f} s")
    for name, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if any(word in line for word in ("registers", "spill", "error", "warning")):
                log(f"  nvcc {name}: {line.strip()}")
    for name, build in mutants.items():
        if build.code != 0:
            raise SystemExit(f"mutant {name} did not build:\n{build.report}")
    return {name: build.library for name, build in mutants.items()}


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report for ``csrc/<name>.cu``: the one of this
    process's build, or of a build made now when the library was there."""
    if name not in _cuda.build_logs:
        with tempfile.TemporaryDirectory(prefix="ptxas_") as tmp:
            _cuda.build_logs[name] = subprocess.run(
                _cuda.nvcc_command(_cuda.CSRC / f"{name}.cu", Path(tmp) / f"lib{name}.so"),
                check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True).stdout
    return _cuda.build_logs[name]


def check_instantiations(library: Path, report: str, kernel: str, decode, mma: str, want: dict) -> None:
    """The ``kernel`` instantiations of ``library`` (by ``decode``'s key) are
    those of ``want`` and run their products as warpgroup MMAs (``mma`` in
    their SASS) with the register reallocation (USETMAXREG, the SASS of
    ``setmaxnreg``, once for the consumers and once for the producer).  In
    ptxas's ``report`` each spills nothing and holds ``want[key]`` registers
    at launch (fewer would leave the consumers' ``setmaxnreg.inc`` waiting
    for ever, so this runs before any launch), and ptxas neither ignores the
    setmaxnreg nor serialises the wgmma."""
    sass = {decode(name): kernel_tools.sass_ops(body, (mma, "USETMAXREG"))
            for name, body in kernel_tools.sass_functions(library).items() if kernel in name}
    log(f"SASS of {library.name}: {mma} and USETMAXREG per {kernel} instantiation {sass}")
    if set(sass) != set(want) or not all(ops[mma] and ops["USETMAXREG"] >= 2 for ops in sass.values()):
        raise SystemExit(f"the {kernel} instantiations of {library.name} are {sorted(sass)}, not {sorted(want)}, "
                         f"or do not all run wgmma ({mma}) and reallocate registers (USETMAXREG)")
    ptxas = {decode(name): info for name, info in kernel_tools.ptxas_kernels(report).items() if kernel in name}
    log(f"ptxas of {library.name}, per {kernel} instantiation: {ptxas}")
    if remarks := kernel_tools.ptxas_remarks(report):
        raise SystemExit(f"ptxas ignored setmaxnreg or serialised wgmma in {library.name}:\n" + "\n".join(remarks))
    if set(ptxas) != set(want):
        raise SystemExit(f"ptxas reported {sorted(ptxas)} in {library.name}, the SASS holds {sorted(want)}")
    for key, info in ptxas.items():
        if info.get("spills") != 0 or info.get("registers") != want[key]:
            raise SystemExit(f"{kernel}{key} of {library.name}: {info}; it must spill nothing and hold "
                             f"{want[key]} registers at launch")


def check_sass(flash_library: Path, int8_libraries: dict[str, Path]) -> None:
    """``check_instantiations`` of the tensor-core kernels: the six bf16
    instantiations of ``flash_tc_kernel`` run HGMMA with ``flash.tc_block``'s
    launch registers; the GEMM instantiations of the int8 core
    (``int8_wgmma.cuh`` ``gemm_kernel``) in each int8 kernel's library, one
    an epilogue of ``quant.INT8_EPILOGUES``, run IGMMA (the SASS of
    ``wgmma.mma_async ... .s32.s8.s8``) on the schedule ``quant.INT8_GEMMS``
    names for the GEMM each serves, with ``quant.gemm_block``'s launch
    registers; and the relative-key kernel ``flash_relkey_kernel`` runs
    HGMMA with ``flash.relkey_block``'s launch registers."""
    check_instantiations(flash_library, ptxas_report("flash_attention"), "flash_tc_kernel", flash.tc_instantiation,
                         "HGMMA", {key: flash.tc_block(key[0])["launch_regs"] for key in flash.TC_INSTANTIATIONS})
    check_instantiations(flash_library, ptxas_report("flash_attention"), "flash_relkey_kernel",
                         flash.relkey_instantiation, "HGMMA",
                         {key: flash.relkey_block()["launch_regs"] for key in flash.RELKEY_INSTANTIATIONS})
    for name, library in int8_libraries.items():
        check_instantiations(library, ptxas_report(name), "gemm_kernel", quant.gemm_instantiation, "IGMMA",
                             {(epilogue, quant.INT8_GEMMS[gemm]): quant.gemm_block(gemm)["launch_regs"]
                              for epilogue, gemm in quant.INT8_EPILOGUES[name].items()})


#: "<sha256> <mangled name>" a line: ``kernel_tools.sass_digest`` of each
#: ``flash_tc_kernel`` instantiation's SASS in an H100 build (sm_90a), after
#: the comment lines that name the toolkit
TC_SASS_DIGESTS = Path(__file__).resolve().parent / "tests" / "fixtures" / "kernels" / "flash_tc_kernel.sass.sha256"


def tc_sass_digests(text: str) -> dict[tuple, str]:
    """TC_SASS_DIGESTS' lines, by instantiation."""
    pairs = (line.split() for line in text.splitlines() if line.strip() and not line.startswith("#"))
    return {flash.tc_instantiation(name): digest for digest, name in pairs}


def check_tc_sass_unchanged(library: Path) -> None:
    """The six bf16 instantiations of ``flash_tc_kernel`` in ``library``
    have the SASS digests that TC_SASS_DIGESTS records, instruction for
    instruction: a kernel added beside them leaves them as they were."""
    want = tc_sass_digests(TC_SASS_DIGESTS.read_text())
    got = {flash.tc_instantiation(name): kernel_tools.sass_digest(body)
           for name, body in kernel_tools.sass_functions(library).items() if "flash_tc_kernel" in name}
    differ = sorted(key for key in set(got) | set(want) if got.get(key) != want.get(key))
    log(f"flash_tc_kernel SASS against {TC_SASS_DIGESTS.name}: {len(got)} instantiations, differing "
        f"{differ or 'none'}")
    if differ or sorted(got) != sorted(flash.TC_INSTANTIATIONS):
        raise SystemExit(f"the flash_tc_kernel instantiations {differ} differ from the recorded SASS "
                         f"({TC_SASS_DIGESTS}; a change to the kernel, or another toolkit, records it anew)")


def qkv(shape, dtype, strided: bool, gen: torch.Generator, device="cuda"):
    """q, k, v on the card; ``strided`` takes them as the trunk does, as
    head-split views of one fused (B, T, 3, H, Dh) projection."""
    b, h, t, dh = shape
    if strided:
        fused = torch.randn((b, t, 3, h, dh), generator=gen, device=device).to(dtype)
        return fused.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3)]


def check_attention(peaks: dict[str, float]) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        (FLAGSHIP, torch.float32, True),
        (FLAGSHIP, torch.bfloat16, False),
        ((2, 4, 37, 24), torch.float32, False),
        ((1, 1, 1, 8), torch.float32, False),
        ((2, 3, 513, 64), torch.float32, False),
        ((2, 3, 513, 64), torch.bfloat16, True),
        # rows of 30 fp32 values, 120 B apart: the one-element route
        ((1, 3, 45, 30), torch.float32, True),
    ]
    flagship_err = None
    for shape, dtype, strided in cases:
        q, k, v = qkv(shape, dtype, strided, gen)
        out = attn._attention_cuda(q, k, v)
        torch.cuda.synchronize()
        ref = attn.dot_product_attention(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        route = "vector" if attn.vector_layout(shape[-1], [x.stride() for x in (q, k, v, out)],
                                              [x.data_ptr() for x in (q, k, v, out)],
                                              q.element_size()) else "scalar"
        ok = out.dtype == dtype and out.shape == q.shape and err <= TOL[dtype]
        log(f"attention {shape} {str(dtype)[6:]}{' strided' if strided else ''} ({route} loads): "
            f"max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("attention kernel disagrees with its plain version")
        if shape == FLAGSHIP and dtype == torch.float32:
            flagship_err = err

    # the autograd.Function's analytic backward against autograd of the plain version
    q, k, v = qkv((2, 3, 37, 24), torch.float32, False, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    attn.fused_attention(*a).backward(g)
    attn.dot_product_attention(*b).backward(g)
    grad_err = max((x.grad - y.grad).abs().max().item() for x, y in zip(a, b))
    log(f"attention grads (2, 3, 37, 24): max_abs_err {grad_err:.3e} (tol 1e-5)")
    if grad_err > 1e-5:
        raise SystemExit("attention backward disagrees with autograd of the plain version")

    # times at the main path's shape and layout
    q, k, v = qkv(FLAGSHIP, torch.float32, True, gen)
    b_, h_, t_, dh_ = FLAGSHIP
    kernel_ms = time_ms(lambda: attn._attention_cuda(q, k, v))
    plain_ms = time_ms(lambda: attn.dot_product_attention(q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    flops = 4 * b_ * h_ * t_ * t_ * dh_
    nbytes = 4 * b_ * h_ * t_ * dh_ * q.element_size()
    seconds, bound_by = bound_s(flops, nbytes, peaks["float32"], peaks)
    bound_ms = 1e3 * seconds
    qb, kb, vb = qkv(FLAGSHIP, torch.bfloat16, True, gen)
    bf16_ms = time_ms(lambda: attn._attention_cuda(qb, kb, vb))
    bf16_bound = 1e3 * bound_s(flops, nbytes / 2, peaks["bfloat16"], peaks)[0]
    log(f"attention {FLAGSHIP} fp32: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; {rates(flops, kernel_ms, library_ms, bound_ms)})")
    log(f"attention {FLAGSHIP} bf16: kernel {bf16_ms:.4f} ms, bound {bf16_bound:.4f} ms")
    return kernel_record("attention", "attention.cu",
                         "algonauts2025_tpu/ops/attention.py:80 (_attn_kernel)", flagship_err,
                         kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


def check_w8a8(peaks: dict[str, float]) -> dict:
    """Kernel B against its plain version: exact equality.  An unaligned K
    must raise before any launch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    main_err = None
    # ViT-G; fp32 out; one row and one 128-deep stage; a ragged M with an N
    # of three 128-wide tiles; fp32 x
    for m, k, n, x_dtype, out_dtype in [(VITG_M, VITG_D, VITG_D, torch.bfloat16, torch.bfloat16),
                                        (130, 384, 640, torch.bfloat16, torch.float32),
                                        (1, 128, 128, torch.bfloat16, torch.bfloat16),
                                        (300, 1408, 384, torch.bfloat16, torch.bfloat16),
                                        (130, 384, 640, torch.float32, torch.float32)]:
        x, w_q, w_s, sx, bias, w_t = w8a8_case(m, k, n, x_dtype, gen)
        out = quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, out_dtype=out_dtype, w_kmajor=w_t)
        torch.cuda.synchronize()
        ref = quant.int8_matmul_fused_plain(x, w_q, w_s, sx, bias=bias, out_dtype=out_dtype)
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.dtype == out_dtype and torch.equal(out, ref)
        log(f"w8a8 ({m}, {k}, {n}) {str(x_dtype)[6:]} -> {str(out_dtype)[6:]}: max_abs_err {err:.3e} "
            f"(exact equality) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the w8a8 kernel is not equal to its plain version")
        if m == VITG_M:
            main_err = err
    poisoned = quant.int8_matmul_fused(x, w_q, w_s, torch.zeros((), device="cuda"), bias=bias, w_kmajor=w_t)
    if not torch.isnan(poisoned).all():
        raise SystemExit("the w8a8 kernel did not poison a_scale = 0 with NaN")
    log("w8a8 a_scale = 0: all NaN ok")
    x, w_q, w_s, sx, bias, w_t = w8a8_case(64, 192, 128, torch.bfloat16, gen)
    before = quant.launch_counts["w8a8"]
    try:
        quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t)
        refused = False
    except ValueError:
        refused = True
    log(f"w8a8 (64, 192, 128) refused with ValueError: {refused}, launches "
        f"{quant.launch_counts['w8a8'] - before}")
    if not refused or quant.launch_counts["w8a8"] != before:
        raise SystemExit("the w8a8 kernel took an unaligned K")

    m, k, n = VITG_M, VITG_D, VITG_D
    x, w_q, w_s, sx, bias, w_t = w8a8_case(m, k, n, torch.bfloat16, gen)
    sxs = quant._static_scale(sx)

    def library(w):
        xq = torch.clamp(torch.round(x.float() / sxs), -127, 127).to(torch.int8)
        return (torch._int_mm(xq, w).float() * (sxs * w_s) + bias).to(torch.bfloat16)

    def kernel():
        return quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t)

    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(lambda: quant.int8_matmul_fused_plain(x, w_q, w_s, sx, bias=bias), iters=5)
    library_ms = time_ms(lambda: library(w_t.t()))
    library_rm_ms = time_ms(lambda: library(w_q))
    ops = 2 * m * k * n
    nbytes = m * k * 2 + k * n + 8 * n + m * n * 2
    seconds, bound_by = bound_s(ops, nbytes, peaks["int8"], peaks)
    bound_ms = 1e3 * seconds
    log(f"w8a8 ({m}, {k}, {n}) bf16: kernel {kernel_ms:.4f} ms ({ops / kernel_ms / 1e9:.1f} TOP/s, "
        f"{bound_ms / kernel_ms:.3f} of the bound), plain {plain_ms:.4f} ms, _int_mm + quant passes "
        f"{library_ms:.4f} ms with the K-major copy as (K, N) ({ops / library_ms / 1e9:.1f} TOP/s), "
        f"{library_rm_ms:.4f} ms with the (K, N) row-major weight, bound {bound_ms:.4f} ms "
        f"({ops / 1e9:.1f} GOP, {nbytes / 1e6:.1f} MB)")
    xq = torch.clamp(torch.round(x.float() / sxs), -127, 127).to(torch.int8)
    time_int_mm("w8a8", xq, {"(K, N) row-major": w_q, "K-major copy as (K, N)": w_t.t()})
    parts = parts_ms(profile_run("w8a8 x 10 at ViT-G", lambda: [kernel() for _ in range(10)], 10 * kernel_ms,
                                 top=4), 10, {"quantize": "quantize_kernel", "GEMM": "gemm_kernel"})
    log(f"w8a8 ({m}, {k}, {n}) a call under the profiler: quantize pass {parts['quantize']:.4f} ms, GEMM "
        f"{parts['GEMM']:.4f} ms ({ops / parts['GEMM'] / 1e9:.1f} TOP/s); " + l2_line("w8a8", m, n, k, nbytes))
    check_w8a8_rope(gen)
    return kernel_record("w8a8", "w8a8.cu", "algonauts2025_tpu/ops/quant.py:107 (_fused_w8a8_kernel)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


def rope_tables(tokens: int, start: int = 0, total: int | None = None, head_dim: int = 64):
    """The V-JEPA rotary tables, fp32 on the card, of tokens [start, start +
    tokens) of ``total`` at ViT-G's crop and patch (a sequence-parallel
    shard's slice when start > 0)."""
    tables = vjepa2._rope_tables(total or tokens, head_dim, VJEPA2_VITG.crop_size, VJEPA2_VITG.patch_size)
    return tuple(torch.from_numpy(t[start:start + tokens]).cuda() for t in tables)


def check_w8a8_rope(gen: torch.Generator) -> None:
    """The w8a8 kernel's rotating entry (the query's and key's) against its
    plain version, exact equality: at ViT-G with its (8192, 64) tables for
    two weights, over a shard's slice of the tables, at head dims 128 and 32
    with a ragged M and fp32 x; NaN from a_scale = 0; the wrapper and the C
    entry refuse bad tables without a launch.  Then the device ms a call of
    the plain epilogue and of the rotating one, and of the plain epilogue
    with ``_apply_rope`` after it (the route it replaces), side by side."""
    m, k, n = VITG_M, VITG_D, VITG_D
    tokens = m // 4
    cases = [("query", m, k, n, torch.bfloat16, rope_tables(tokens)),
             ("key", m, k, n, torch.bfloat16, rope_tables(tokens)),
             ("tokens 4096-6143 of 8192", 4 * 2048, k, n, torch.bfloat16, rope_tables(2048, 4096, tokens)),
             ("hd 128, 96 tokens", 2 * 96, 384, 256, torch.bfloat16, rope_tables(96, head_dim=128)),
             ("hd 32, fp32 x", 3 * 64, 256, 128, torch.float32, rope_tables(64, 64, 256, head_dim=32))]
    for label, mm, kk, nn, x_dtype, tables in cases:
        x, w_q, w_s, sx, bias, w_t = w8a8_case(mm, kk, nn, x_dtype, gen)
        out = quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t, rope=tables)
        torch.cuda.synchronize()
        ref = quant.int8_matmul_fused_plain(x, w_q, w_s, sx, bias=bias, rope=tables)
        dense = quant.int8_matmul_fused_plain(x, w_q, w_s, sx, bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.dtype == torch.bfloat16 and torch.equal(out, ref) and not torch.equal(out, dense)
        log(f"w8a8_rope {label} ({mm}, {kk}, {nn}), tables {tuple(tables[0].shape)}: max_abs_err {err:.3e} "
            f"(exact equality) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the rotating w8a8 kernel is not equal to its plain version")
    poisoned = quant.int8_matmul_fused(x, w_q, w_s, torch.zeros((), device="cuda"), bias=bias, w_kmajor=w_t,
                                       rope=tables)
    if not torch.isnan(poisoned).all():
        raise SystemExit("the rotating w8a8 kernel did not poison a_scale = 0 with NaN")
    before = dict(quant.launch_counts)
    refused = []
    for bad in ((torch.ones(64, 96, device="cuda"), torch.zeros(64, 96, device="cuda")),
                tuple(t[:60].contiguous() for t in tables)):
        try:
            quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t, rope=bad)
        except ValueError:
            refused.append(True)
    xq = torch.empty(x.shape, dtype=torch.int8, device="cuda")
    out = torch.empty((x.shape[0], w_t.shape[0]), dtype=torch.bfloat16, device="cuda")
    sxs = quant._static_scale(sx).reshape(1)
    with torch.cuda.device(x.device):
        code = _cuda.function(*quant._W8A8_ROPE)(
            x.data_ptr(), _cuda.DTYPE_CODES[x.dtype], w_t.data_ptr(), w_s.data_ptr(), bias.data_ptr(), sxs.data_ptr(), xq.data_ptr(),
            out.data_ptr(), 1, x.shape[0], w_t.shape[0], x.shape[1], tables[0].data_ptr(), tables[1].data_ptr(),
            60, 32, torch.cuda.current_stream().cuda_stream)
    log(f"w8a8_rope: a_scale = 0 all NaN ok; tables (64, 96) and T = 60 refused by the wrapper: {refused}; "
        f"T = 60 refused by the C entry with {code}; launches {dict(quant.launch_counts)} (before {before})")
    if refused != [True, True] or code == 0 or quant.launch_counts != before:
        raise SystemExit("the rotating w8a8 kernel took tables it must refuse")

    x, w_q, w_s, sx, bias, w_t = w8a8_case(m, k, n, torch.bfloat16, gen)
    tables = rope_tables(tokens)

    def plain_epilogue():
        return quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t)

    def rotating_epilogue():
        return quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t, rope=tables)

    def apply_rope_after():
        heads = plain_epilogue().reshape(4, tokens, n // 64, 64).transpose(1, 2)
        return vjepa2._apply_rope(heads, *tables)

    times = {"plain": [], "rotating": [], "plain + _apply_rope": []}
    for label in ("plain", "rotating", "plain + _apply_rope", "plain + _apply_rope", "rotating", "plain"):
        fn = {"plain": plain_epilogue, "rotating": rotating_epilogue, "plain + _apply_rope": apply_rope_after}
        times[label].append(time_ms(fn[label]))
    ms = {label: statistics.mean(v) for label, v in times.items()}
    parts = parts_ms(profile_run("w8a8 plain and rotating x 10 each at ViT-G",
                                 lambda: [f() for f in [plain_epilogue, rotating_epilogue] * 10],
                                 10 * (ms["plain"] + ms["rotating"]), top=4), 10,
                     {"quantize": "quantize_kernel", "plain GEMM": "gemm_kernel<i8wg::StoreDequant<",
                      "rotating GEMM": "StoreDequantRope"})
    log(f"w8a8 ({m}, {k}, {n}) bf16, a call (CUDA events, in turns P R A A R P): plain epilogue "
        f"{ms['plain']:.4f} ms, rotating epilogue {ms['rotating']:.4f} ms, plain + _apply_rope "
        f"{ms['plain + _apply_rope']:.4f} ms; under the profiler: GEMM plain {parts['plain GEMM']:.4f} ms, "
        f"rotating {parts['rotating GEMM']:.4f} ms, quantize pass {parts['quantize'] / 2:.4f} ms")


def time_int_mm(label: str, a: torch.Tensor, weights: dict[str, torch.Tensor]) -> None:
    """``torch._int_mm(a, w)`` alone for each (K, N) layout of the weight:
    the GEMM-only yardstick of the int8 core."""
    times = {layout: time_ms(lambda: torch._int_mm(a, w), iters=10) for layout, w in weights.items()}
    log(f"torch._int_mm alone, {label} ({tuple(a.shape)} x {tuple(next(iter(weights.values())).shape)}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))


def l2_line(gemm: str, m: int, n: int, k: int, nbytes: float) -> str:
    """The bytes ``gemm`` reads from L2 in its tiles, beside 128 x 128 tiles'
    and the bound's device-memory bytes."""
    block = quant.gemm_block(gemm)
    l2 = quant.gemm_l2_read_bytes(m, n, k, block["tile_m"], block["tile_n"])
    return (f"{gemm} L2 read bytes in {block['tile_m']} x {block['tile_n']} tiles ({block['schedule']}) "
            f"{l2 / 1e9:.3f} GB (128 x 128 tiles: {quant.gemm_l2_read_bytes(m, n, k, 128, 128) / 1e9:.3f} GB; "
            f"the bound counts {nbytes / 1e6:.1f} MB of device memory)")


def check_int8_mlp(peaks: dict[str, float]) -> dict:
    """Kernel C against its plain version: relative L2 <= 1e-3 and max-abs
    <= 1e-2 max|ref| (the gelu's expf against PyTorch's exp can flip rare
    int8 roundings of the hidden state); the share of outputs that are not
    bit-equal is reported."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    main_err = None
    # ViT-G; a ragged M; one row and one 128-deep stage; a ragged M with an
    # F of three 128-wide tiles
    for m, k, f in [(VITG_M, VITG_D, VITG_F), (130, 256, 512), (1, 128, 128), (300, 1408, 384)]:
        args, sx, sh = mlp_case(m, k, f, gen)
        out = quant.int8_mlp_fused(*args, sx, sh, out_dtype=torch.bfloat16, **kmajor(args))
        torch.cuda.synchronize()
        ref = quant.int8_mlp_fused_plain(*args, sx, sh)
        o, r = out.float(), ref.float()
        err = (o - r).abs().max().item()
        rel = rel_l2(o, r)
        unequal = (out != ref).float().mean().item()
        ok = rel <= 1e-3 and err <= 1e-2 * r.abs().max().item()
        log(f"int8_mlp ({m}, {k}, {f}): rel L2 {rel:.3e} (tol 1e-3), max_abs_err {err:.3e} "
            f"(tol {1e-2 * r.abs().max().item():.3e}), not bit-equal {unequal:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the int8 MLP kernel disagrees with its plain version")
        if m == VITG_M:
            main_err = err
    zero = torch.zeros((), device="cuda")
    for bad in ((zero, sh), (sx, zero)):
        if not torch.isnan(quant.int8_mlp_fused(*args, *bad, **kmajor(args))).all():
            raise SystemExit("the int8 MLP kernel did not poison both scales together")
    log("int8_mlp x_scale = 0 / h_scale = 0: all NaN ok")

    m, k, f = VITG_M, VITG_D, VITG_F
    args, sx, sh = mlp_case(m, k, f, gen)
    x, w1_q, w1_s, b1, w2_q, w2_s, b2 = args
    km = kmajor(args)
    sc = quant._coupled_scales(sx, sh, "cuda")

    def library():
        xq = torch.clamp(torch.round(x.float() / sc[0]), -127, 127).to(torch.int8)
        h = quant.gelu_erf_approx(torch._int_mm(xq, w1_q).float() * (sc[0] * w1_s) + b1)
        hq = torch.clamp(torch.round(h / sc[1]), -127, 127).to(torch.int8)
        return (torch._int_mm(hq, w2_q).float() * (sc[1] * w2_s) + b2).to(torch.bfloat16)

    kernel_ms = time_ms(lambda: quant.int8_mlp_fused(*args, sx, sh, **km), iters=10)
    plain_ms = time_ms(lambda: quant.int8_mlp_fused_plain(*args, sx, sh), iters=3, warmup=1)
    library_ms = time_ms(library, iters=10)
    ops = 2 * m * k * f * 2
    nbytes = m * k * 2 + 2 * k * f + 8 * (f + k) + m * k * 2
    seconds, bound_by = bound_s(ops, nbytes, peaks["int8"], peaks)
    bound_ms = 1e3 * seconds
    log(f"int8_mlp ({m}, {k}, {f}) bf16: kernel {kernel_ms:.4f} ms ({ops / kernel_ms / 1e9:.1f} TOP/s), "
        f"plain {plain_ms:.4f} ms, _int_mm + quant/gelu passes {library_ms:.4f} ms "
        f"({ops / library_ms / 1e9:.1f} TOP/s), bound {bound_ms:.4f} ms "
        f"({ops / 1e12:.3f} TOP, {nbytes / 1e6:.1f} MB)")
    parts = parts_ms(profile_run("int8_mlp x 10 at ViT-G",
                                 lambda: [quant.int8_mlp_fused(*args, sx, sh, **km) for _ in range(10)],
                                 10 * kernel_ms, top=4), 10,
                     {"quantize": "quantize_kernel", "fc1": "StoreGeluQuant", "fc2": "StoreDequant"})
    gemm_ops = 2 * m * k * f
    log(f"int8_mlp ({m}, {k}, {f}) a call under the profiler: quantize pass {parts['quantize']:.4f} ms, "
        f"fc1 {parts['fc1']:.4f} ms ({gemm_ops / parts['fc1'] / 1e9:.1f} TOP/s), fc2 {parts['fc2']:.4f} ms "
        f"({gemm_ops / parts['fc2'] / 1e9:.1f} TOP/s), fc1 / fc2 {parts['fc1'] / parts['fc2']:.3f}; "
        + l2_line("fc1", m, f, k, nbytes) + "; " + l2_line("fc2", m, k, f, nbytes))
    xq = torch.clamp(torch.round(x.float() / sc[0]), -127, 127).to(torch.int8)
    hq = torch.randint(-127, 128, (m, f), generator=gen, device="cuda", dtype=torch.int8)
    time_int_mm("fc1", xq, {"(K, N) row-major": w1_q, "K-major copy as (K, N)": km["w1_kmajor"].t()})
    time_int_mm("fc2", hq, {"(K, N) row-major": w2_q, "K-major copy as (K, N)": km["w2_kmajor"].t()})
    return kernel_record("int8_mlp", "int8_mlp.cu",
                         "algonauts2025_tpu/ops/quant.py:230 (_fused_mlp_kernel)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


# one ViT-G window batch of 4: (B, H, T, d) of its attention, and its
# operations (q kᵀ and P V over every pair)
VITG_ATTN = (4, 22, 8192, 64)
VITG_FLOPS = 4 * VITG_ATTN[0] * VITG_ATTN[1] * VITG_ATTN[2] ** 2 * VITG_ATTN[3]
# relative L2 limits of the attention kernel against its plain version.  At
# 8192 standard-normal keys a row's softmax spreads over ~T/e keys, so a
# dropped or doubled 64-key tile moves the output by ~9 % in relative L2;
# the kernel's running max rounds p to bf16 under other shifts than the
# plain version's final max, which with the bf16 output's rounding leaves a
# few 1e-3 in bf16, while fp32 differs only in the order of its sums.
FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def flash_case(label: str, out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
               rel_limits: dict = FLASH_REL) -> tuple[bool, float]:
    """check_flash's comparison: max-abs within min(TOL, 1e-2 max|ref|),
    relative L2 within ``rel_limits``, finite, the input's dtype and shape.
    Returns whether it held and the max-abs error."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    rel = rel_l2(o, r)
    limit = min(TOL[dtype], 1e-2 * r.abs().max().item())
    ok = (out.dtype == dtype and out.shape == ref.shape and torch.isfinite(out).all().item()
          and err <= limit and rel <= rel_limits[dtype])
    log(f"{label}: max_abs_err {err:.3e} (tol {limit:.3e}), rel L2 {rel:.3e} (tol {rel_limits[dtype]:.0e}), "
        f"max|ref| {r.abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
    return ok, err


def rates(flops: float, kernel_ms: float, library_ms: float, bound_ms: float) -> str:
    """The kernel's and the library call's TFLOP/s beside the bound's."""
    return (f"kernel {flops / kernel_ms / 1e9:.1f} TFLOP/s, sdpa {flops / library_ms / 1e9:.1f}, "
            f"bound {flops / bound_ms / 1e9:.1f}")


def time_bench_shape(peaks, kernel, plain) -> tuple[float, float, float, float, str, str]:
    """Kernel, plain and ``scaled_dot_product_attention`` times at the
    bench's (4, 22, 8192, 64) bf16 strided shape, and the bound (one ex2 a
    score: B H T^2) with its terms."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    b, h, t, d = VITG_ATTN
    q, k, v = qkv(VITG_ATTN, torch.bfloat16, True, gen)
    kernel_ms = time_ms(lambda: kernel(q, k, v))
    plain_ms = time_ms(lambda: plain(q, k, v), iters=2, warmup=1)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    bound_ms, bound_by, terms = flash_bound(VITG_FLOPS, 4 * b * h * t * d * 2, b * h * t * t, peaks)
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by, terms


def check_flash(peaks: dict[str, float]) -> dict:
    """Kernel A through the backbone's wrapper against its plain version
    (computed in query chunks): max-abs within the port's tolerance and
    1e-2 max|ref|, and relative L2 within ``FLASH_REL``.  Each fp32 edge
    case has a bf16 twin (fp32 runs the CUDA-core loop, bf16 the
    tensor-core one); d = 96 runs the bf16 loop at 128, zero-padded."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    main_err = None
    cases = [(VITG_ATTN, torch.bfloat16, True, 1.0),
             ((1, 22, 8192, 64), torch.float32, True, 1.0),
             *((shape, dtype, strided, scale) for dtype in (torch.float32, torch.bfloat16)
               for shape, strided, scale in (((2, 3, 1024, 64), False, 1.0), ((1, 2, 1, 64), False, 1.0),
                                             ((1, 2, 1000, 64), True, 1.0), ((1, 2, 1024, 64), False, 30.0))),
             ((1, 2, 37, 64), torch.bfloat16, False, 1.0),
             ((2, 3, 1000, 96), torch.bfloat16, True, 1.0)]
    for shape, dtype, strided, scale in cases:
        q, k, v = qkv(shape, torch.float32, strided, gen)
        q, k, v = (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)
        out = flash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ok, err = flash_case(f"flash_attention {shape} {str(dtype)[6:]}{' strided' if strided else ''}"
                             f"{f' x{scale:g}' if scale != 1 else ''}", out,
                             flash.bounded_attention_plain(q, k, v), dtype)
        if not ok:
            raise SystemExit("the flash attention kernel disagrees with its plain version")
        if shape == VITG_ATTN:
            main_err = err

    kernel_ms, plain_ms, library_ms, bound_ms, bound_by, terms = time_bench_shape(
        peaks, flash.flash_attention, flash.bounded_attention_plain)
    log(f"flash_attention {VITG_ATTN} bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({terms}; "
        f"{rates(VITG_FLOPS, kernel_ms, library_ms, bound_ms)})")
    return kernel_record("flash_attention", "flash_attention.cu",
                         "algonauts2025_tpu/ops/flash_attention.py:212 (_bounded_kernel)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


# one Llama-3.2-3B batch forward's attention: (B, H, T, d) and its kv heads
LLAMA_ATTN, LLAMA_KV = (8, 24, 1024, 128), 8
# (shape, kv heads, dtype, causal, key lengths): the main path's, then
# padded rows (a length 0 among them), no lengths, non-causal d = 128,
# T = 1 and ragged T, each fp32 case with its bf16 twin; d = 96 (the bf16
# loop at 128, zero-padded) and three query heads a kv head
MASKED_CASES = [
    (LLAMA_ATTN, LLAMA_KV, torch.bfloat16, True, (1024,) * 8),
    (LLAMA_ATTN, LLAMA_KV, torch.bfloat16, True, (1024, 700, 256, 1, 0, 1024, 512, 999)),
    *((shape, kv, dtype, causal, lengths) for dtype in (torch.float32, torch.bfloat16)
      for shape, kv, causal, lengths in (((1, 24, 1024, 128), LLAMA_KV, True, None),
                                         ((2, 4, 256, 128), 4, False, (0, 256)),
                                         ((2, 4, 1, 64), 2, True, (1, 0)),
                                         ((2, 4, 300, 128), 2, True, (300, 129)))),
    ((2, 4, 37, 64), 2, torch.bfloat16, True, (37, 20)),
    ((2, 4, 200, 96), 2, torch.bfloat16, True, (200, 77)),
    ((2, 6, 300, 128), 2, torch.bfloat16, True, (300, 150)),
]
# limits of the masked kernel against its plain version, set from the
# first readings on an H100 (PERF.md): max-abs within MASKED_TOL and
# 1e-2 max|ref|; relative L2 within MASKED_REL, ~4x the largest reading
# (bf16 1.3e-3 at the main case, fp32 1.7e-7).  bf16 max-abs stays at the
# port's 3e-2: one output of magnitude 2-4 whose fp32 sum lands on the other
# side of a bf16 rounding boundary already differs by 1.6e-2
MASKED_TOL = {torch.float32: 2e-6, torch.bfloat16: 3e-2}
MASKED_REL = {torch.float32: 1e-6, torch.bfloat16: 5e-3}
# patched copies of csrc/flash_attention.cu whose masked kernel must fail
# check_flash_masked: (the line of flash_forward_masked, its replacement)
MUTANTS = {
    "ignores_lengths": ("p.lengths = lengths;", "p.lengths = nullptr;"),
    "ignores_causal": ("p.causal = causal != 0;", "p.causal = 0;"),
}


def masked_qkv(shape, kv_heads, dtype, gen, device="cuda"):
    """q (B, H, T, d) and k, v (B, kv_heads, T, d) as the Llama backbone
    hands them over: head-split views of (B, T, heads, d) projections."""
    b, h, t, d = shape
    return [torch.randn((b, t, n, d), generator=gen, device=device).to(dtype).transpose(1, 2)
            for n in (h, kv_heads, kv_heads)]


def flash_masked_cases(label: str) -> tuple[bool, float]:
    """Run MASKED_CASES through ``flash_attention`` against
    ``flash_attention_plain``: max-abs within ``MASKED_TOL`` and 1e-2
    max|ref|, relative L2 within ``MASKED_REL``, rows of length 0 exactly
    zero.  Returns whether every case passed, and the main case's
    max-abs error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    all_ok, main_err = True, float("nan")
    for shape, kv_heads, dtype, causal, lengths in MASKED_CASES:
        q, k, v = masked_qkv(shape, kv_heads, dtype, gen)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = flash.flash_attention(q, k, v, causal=causal, lengths=lens)
        torch.cuda.synchronize()
        ref = flash.flash_attention_plain(q, k, v, causal, lens)
        o, r = out.float(), ref.float()
        err = (o - r).abs().max().item()
        rel = rel_l2(o, r)
        limit = min(MASKED_TOL[dtype], 1e-2 * r.abs().max().item())
        zero_rows = [i for i, n in enumerate(lengths or ()) if n == 0]
        zeros = all(torch.equal(o[i], torch.zeros_like(o[i])) for i in zero_rows)
        ok = (out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all().item()
              and err <= limit and rel <= MASKED_REL[dtype] and zeros)
        log(f"{label} {shape} kv {kv_heads} {str(dtype)[6:]}{' causal' if causal else ''} "
            f"lengths {lengths}: max_abs_err {err:.3e} (tol {limit:.3e}), rel L2 {rel:.3e} "
            f"(tol {MASKED_REL[dtype]:.0e}), max|ref| {r.abs().max().item():.3e}, "
            f"zero rows exact {zeros} {'ok' if ok else 'FAIL'}")
        all_ok = all_ok and ok
        if shape == LLAMA_ATTN and lengths == (1024,) * 8:
            main_err = err
    return all_ok, main_err


def check_flash_masked(peaks: dict[str, float], mutants: dict[str, Path]) -> dict:
    """The masked flash kernel through the Llama backbone's wrapper against
    its plain version; then each mutant must fail the same cases."""
    ok, main_err = flash_masked_cases("flash_masked")
    if not ok:
        raise SystemExit("the masked flash attention kernel disagrees with its plain version")
    for name, library in mutants.items():
        with mock.patch.object(_cuda, "function", kernel_tools.stand_in({"flash_attention": library})):
            caught = not flash_masked_cases(f"mutant {name}")[0]
        log(f"mutant {name}: {'fails the check, ok' if caught else 'PASSES the check'}")
        if not caught:
            raise SystemExit(f"check_flash_masked does not catch a kernel that {name.replace('_', ' ')}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    b, h, t, d = LLAMA_ATTN
    q, k, v = masked_qkv(LLAMA_ATTN, LLAMA_KV, torch.bfloat16, gen)
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
    # 50 calls: ~8 ms of work, so that a clock change in the run weighs little
    kernel_ms = time_ms(lambda: flash.flash_attention(q, k, v, causal=True, lengths=lens), iters=50)
    plain_ms = time_ms(lambda: flash.flash_attention_plain(q, k, v, True, lens), iters=3, warmup=1)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=50)
    # the kept (query, key) pairs of this call: causal rows keep row + 1 keys
    # (one ex2 a kept pair and head)
    pairs = sum(min(r + 1, n) for n in lens.tolist() for r in range(t))
    flops = 4 * d * h * pairs
    nbytes = 2 * (2 * b * h * t * d + 2 * b * LLAMA_KV * t * d)
    bound_ms, bound_by, terms = flash_bound(flops, nbytes, h * pairs, peaks)
    log(f"flash_masked {LLAMA_ATTN} kv {LLAMA_KV} bf16 causal: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({terms}; {rates(flops, kernel_ms, library_ms, bound_ms)})")
    return kernel_record("flash_masked", "flash_attention.cu",
                         "algonauts2025_tpu/ops/flash_attention.py:26 (_flash_kernel)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


# (shape, dtype, strided, score dtype) of check_fast: the bench's shape with
# both score dtypes, fp32, T = 1 and 37, head dims 32 and 128, each fp32
# edge case with its bf16 twin
FAST_CASES = [
    (VITG_ATTN, torch.bfloat16, True, torch.float32),
    (VITG_ATTN, torch.bfloat16, True, torch.bfloat16),
    ((1, 22, 8192, 64), torch.float32, True, torch.float32),
    *((shape, dtype, strided, torch.float32) for dtype in (torch.float32, torch.bfloat16)
      for shape, strided in (((1, 2, 1, 64), False), ((2, 3, 1024, 32), True), ((2, 3, 1024, 128), False))),
    ((1, 2, 37, 64), torch.bfloat16, False, torch.bfloat16),
    ((2, 3, 1000, 128), torch.bfloat16, True, torch.bfloat16),
]


def check_fast(peaks: dict[str, float]) -> dict:
    """The bench-only fast kernel (``_fast_kernel``'s function) against
    ``fast_attention_plain``, with check_flash's limits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    all_ok, main_err = True, None
    for shape, dtype, strided, score_dtype in FAST_CASES:
        q, k, v = (x.to(dtype) for x in qkv(shape, torch.float32, strided, gen))
        out = flash.fast_flash_attention(q, k, v, score_dtype)
        torch.cuda.synchronize()
        ok, err = flash_case(f"flash_fast {shape} {str(dtype)[6:]}{' strided' if strided else ''} "
                             f"scores {str(score_dtype)[6:]}", out, flash.fast_attention_plain(q, k, v, score_dtype),
                             dtype)
        all_ok = all_ok and ok
        if shape == VITG_ATTN and score_dtype == torch.float32:
            main_err = err
    # bf16 scores on fp32 inputs: q and k on a grid of 1/8 make every fp32
    # score exact in any order of the sum, so kernel and plain version round
    # the same scores to bf16 and must meet the fp32 limits; the result must
    # then differ from the fp32-score kernel's by more than those limits
    q, k, v = qkv((1, 4, 2048, 64), torch.float32, True, gen)
    q, k = ((x * 8).round().clamp(-16, 16) / 8 for x in (q, k))
    b16 = flash.fast_flash_attention(q, k, v, torch.bfloat16)
    ok, _ = flash_case("flash_fast (1, 4, 2048, 64) float32 on a 1/8 grid, scores bfloat16", b16,
                       flash.fast_attention_plain(q, k, v, torch.bfloat16), torch.float32)
    f32 = flash.fast_flash_attention(q, k, v)
    moved = (b16 - f32).abs().max().item()
    limit = min(TOL[torch.float32], 1e-2 * f32.abs().max().item())
    log(f"flash_fast bf16 vs fp32 scores on the kernel: max |diff| {moved:.3e} (must exceed {limit:.3e})")
    if not (all_ok and ok and moved > limit):
        raise SystemExit("the fast flash kernel disagrees with its plain version, or ignores score_dtype")

    kernel_ms, plain_ms, library_ms, bound_ms, bound_by, terms = time_bench_shape(
        peaks, flash.fast_flash_attention, flash.fast_attention_plain)
    q, k, v = qkv(VITG_ATTN, torch.bfloat16, True, gen)
    b16_ms = time_ms(lambda: flash.fast_flash_attention(q, k, v, torch.bfloat16))
    log(f"flash_fast {VITG_ATTN} bf16: kernel {kernel_ms:.4f} ms (bf16 scores {b16_ms:.4f} ms, "
        f"{VITG_FLOPS / b16_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({terms}); {rates(VITG_FLOPS, kernel_ms, library_ms, bound_ms)}")
    return kernel_record("flash_fast", "flash_attention.cu",
                         "algonauts2025_tpu/ops/flash_attention.py:105 (_fast_kernel)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


# (shape, dtype, strided) of check_packed: the bench's shape, fp32, T = 1
# and 37, and a head count the JAX version's block rule would refuse, each
# fp32 edge case with its bf16 twin
PACKED_CASES = [
    (VITG_ATTN, torch.bfloat16, True),
    ((1, 22, 8192, 64), torch.float32, True),
    *((shape, dtype, strided) for dtype in (torch.float32, torch.bfloat16)
      for shape, strided in (((1, 2, 1, 64), False), ((3, 6, 1000, 64), True))),
    ((1, 2, 37, 64), torch.bfloat16, False),
]


def check_packed(peaks: dict[str, float]) -> dict:
    """The bench-only packed kernel (``_flash_kernel_packed``'s function)
    against ``packed_attention_plain``, with check_flash's limits; d = 32
    and an odd head count must raise."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    all_ok, main_err = True, None
    for shape, dtype, strided in PACKED_CASES:
        q, k, v = (x.to(dtype) for x in qkv(shape, torch.float32, strided, gen))
        out = flash.flash_attention_packed(q, k, v)
        torch.cuda.synchronize()
        ok, err = flash_case(f"flash_packed {shape} {str(dtype)[6:]}{' strided' if strided else ''}", out,
                             flash.packed_attention_plain(q, k, v), dtype)
        all_ok = all_ok and ok
        if shape == VITG_ATTN:
            main_err = err
    refused = 0
    for shape in ((1, 2, 64, 32), (1, 3, 64, 64)):
        q = torch.zeros(shape, device="cuda")
        try:
            flash.flash_attention_packed(q, q, q)
        except ValueError:
            refused += 1
    log(f"flash_packed refuses d = 32 and H = 3: {refused == 2}")
    if not (all_ok and refused == 2):
        raise SystemExit("the packed flash kernel disagrees with its plain version, or takes a bad shape")

    kernel_ms, plain_ms, library_ms, bound_ms, bound_by, terms = time_bench_shape(
        peaks, flash.flash_attention_packed, flash.packed_attention_plain)
    log(f"flash_packed {VITG_ATTN} bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({terms}); "
        f"{rates(VITG_FLOPS, kernel_ms, library_ms, bound_ms)}")
    return kernel_record("flash_packed", "flash_attention.cu",
                         "algonauts2025_tpu/ops/flash_attention.py:424 (_flash_kernel_packed)",
                         main_err, kernel_ms, plain_ms, library_ms, bound_ms, bound_by)


# the w2v-BERT 2.0 attention of a chunk at the 30, 60 and 90 s buckets'
# frames (B, H, T, d), its distance band (left, right), and each case's
# valid frames a few short of T; then two batch rows (one with padded keys)
# and short T.  Each case runs with the distance table at the model's init
# scale (std 0.02) and at std 1, where the bias is as large as q k^T
RELKEY_SHAPES = [(1, 16, 1500, 64), (1, 16, 3000, 64), (1, 16, 4500, 64)]
RELKEY_POS = (64, 8)
RELKEY_CASES = [*((shape, (shape[2] - 3,)) for shape in RELKEY_SHAPES), ((2, 16, 1000, 64), (1000, 517)),
                ((1, 16, 37, 64), None), ((1, 2, 300, 64), (250,))]
RELKEY_TABLE_STDS = (0.02, 1.0)
#: the limit of the kernel against its plain version (relative L2): both
#: round the same normalised fp32 probabilities to bf16, so they differ only
#: where a sum in another order crosses a bf16 rounding boundary; first
#: readings on an H100: up to 1.9e-4 sound, 2.9e-3 and more for the mutants
RELKEY_REL = 4.5e-4
# patched copies of csrc/flash_attention.cu whose relative-key kernel must
# fail check_relkey: the probabilities rounded before they are normalised
# (the single-sweep numerics), and the bias read one distance off
RELKEY_MUTANTS = {
    "rounds_unnormalised_p": [("flash_attention.cu", "p_norm[r] = 1.f / l[r];", "p_norm[r] = 1.f;"),
                              ("flash_attention.cu", "tc::mbar_arrive(empty_v + 8 * sv);\n      ++gv;",
                               "tc::mbar_arrive(empty_v + 8 * sv);\n      ++gv;\n"
                               "      for (int i = 0; i < 32; ++i) o[i] /= l[(i >> 1) & 1];")],
    "band_off_by_one": [("flash_attention.cu", "const int j0 = k0 + c2 - row0 + left;",
                         "const int j0 = k0 + c2 - row0 + left + 1;")],
}


def relkey_cases(label: str) -> tuple[bool, float]:
    """Run RELKEY_CASES through ``relkey_attention`` against
    ``relkey_attention_plain`` with each table scale: relative L2 within
    ``RELKEY_REL``, finite, bf16 of q's shape.  Returns whether every case
    passed and the 60 s case's max-abs error at the init scale."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    left, right = RELKEY_POS
    all_ok, main_err = True, float("nan")
    for (b, h, t, d), lengths in RELKEY_CASES:
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for std in RELKEY_TABLE_STDS:
            table = std * torch.randn((left + right + 1, d), generator=gen, device="cuda")
            out = flash.relkey_attention(q, k, v, table, lens, left, right)
            torch.cuda.synchronize()
            ref = flash.relkey_attention_plain(q, k, v, table, lens, left, right)
            err = (out.float() - ref.float()).abs().max().item()
            rel = rel_l2(out, ref)
            ok = (out.dtype == torch.bfloat16 and out.shape == q.shape and torch.isfinite(out).all().item()
                  and rel <= RELKEY_REL)
            log(f"{label} {(b, h, t, d)} lengths {lengths} table std {std:g}: max_abs_err {err:.3e}, rel L2 "
                f"{rel:.3e} (tol {RELKEY_REL:.1e}) {'ok' if ok else 'FAIL'}")
            all_ok = all_ok and ok
            if t == 3000 and std == RELKEY_TABLE_STDS[0]:
                main_err = err
    return all_ok, main_err


def check_relkey(peaks: dict[str, float], mutants: dict[str, Path]) -> dict:
    """The relative-key kernel against its plain version at the audio
    cell's shapes; each of RELKEY_MUTANTS must fail the same cases; then
    the kernel's and the plain version's time at T = 3000 beside the bound
    (the function's work counted once: q k^T and P v, one ex2 a score)."""
    ok, main_err = relkey_cases("flash_relkey")
    if not ok:
        raise SystemExit("the relative-key attention kernel disagrees with its plain version")
    for name, library in mutants.items():
        with mock.patch.object(_cuda, "function", kernel_tools.stand_in({"flash_attention": library})):
            caught = not relkey_cases(f"mutant {name}")[0]
        log(f"mutant {name}: {'fails the check, ok' if caught else 'PASSES the check'}")
        if not caught:
            raise SystemExit(f"check_relkey does not catch a kernel whose {name.replace('_', ' ')}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    b, h, t, d = RELKEY_SHAPES[1]
    left, right = RELKEY_POS
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    table = 0.02 * torch.randn((left + right + 1, d), generator=gen, device="cuda")
    lens = torch.tensor([t - 3], dtype=torch.int32, device="cuda")
    kernel_ms = time_ms(lambda: flash.relkey_attention(q, k, v, table, lens, left, right), iters=50)
    plain_ms = time_ms(lambda: flash.relkey_attention_plain(q, k, v, table, lens, left, right), iters=3, warmup=1)
    n = t - 3
    flops = 4 * b * h * n * n * d
    bound_ms, bound_by, terms = flash_bound(flops, 2 * 4 * b * h * n * d, b * h * n * n, peaks)
    log(f"flash_relkey {RELKEY_SHAPES[1]} bf16, {n} valid keys: kernel {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / kernel_ms:.1f} % of the bound), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({terms})")
    return kernel_record("flash_relkey", "flash_attention.cu", "none (the JAX package leaves the relative_key "
                         "attention to XLA: _rel_onehot, einsum, softmax)", main_err, kernel_ms, plain_ms, None,
                         bound_ms, bound_by)


@torch.no_grad()
def quantized_backbone(cfg: VJEPA2Config, gen: torch.Generator, device="cuda") -> VJEPA2Backbone:
    """A dynamic-scale int8 backbone from seeded float weights at a dense
    layer's init scale (std 1/sqrt(fan_in)), quantized layer by layer as
    params_from_hf would quantize a checkpoint; LayerNorm gain 1, bias 0."""
    model = VJEPA2Backbone(cfg, token_pool=True, device=device)
    k_patch = model.patch_kernel.shape[0]
    model.patch_kernel.copy_(torch.randn(model.patch_kernel.shape, generator=gen, device=device)
                             / k_patch**0.5)
    for module in model.modules():
        if isinstance(module, _QDense):
            w_q, w_s = quant.quantize_weight(
                torch.randn((module.in_features, module.features), generator=gen, device=device)
                / module.in_features**0.5)
            module.kernel_q.copy_(w_q)
            module.scale.copy_(w_s)
    return model


def check_small_backbone_against_cpu() -> None:
    """A small static-int8 backbone, 1024 tokens so that all three video
    kernels dispatch on the card, against the CPU's plain path from the
    same weights: cosine of the token-pooled features >= 0.999."""
    cfg = VJEPA2Config(crop_size=128, frames_per_clip=32, hidden_size=128, num_layers=2,
                       num_heads=2, mlp_ratio=2.0, quantize=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    model = quantized_backbone(cfg, gen)
    cpu_model = VJEPA2Backbone(cfg, token_pool=True, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model = _calibrated_static_model(cpu_model, 32, 128)
    model.load_state_dict({k: v.cuda() for k, v in cpu_model.state_dict().items()})
    model.set_quant_static()
    gpu = TorchVideoBackbone(model, n_frames=32, crop_size=128)
    cpu = TorchVideoBackbone(cpu_model, n_frames=32, crop_size=128, device="cpu")
    windows = np.random.default_rng(SEED + 5).integers(0, 256, (2, 32, 144, 256, 3), dtype=np.uint8)
    reset_counts()
    a = gpu.encode_windows(windows).astype(np.float64)
    counts = {key: launch_counts()[key] for key in ("flash_attention", "w8a8", "w8a8_rope", "int8_mlp")}
    b = cpu.encode_windows(windows).astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    rel = np.abs(a - b).max() / np.abs(b).max()
    log(f"small int8 backbone (2 layers, 128 wide, 1024 tokens), card vs CPU: min cosine "
        f"{cos.min():.6f} (tol 0.999), worst |diff| / max|ref| {rel:.3e}, launches {counts}")
    if not cos.min() >= 0.999 or min(counts.values()) == 0:
        raise SystemExit("the small int8 backbone on the card disagrees with the CPU")


def check_small_llama_against_cpu() -> None:
    """A small fp32 Llama (2 layers, 256 wide, 2 query heads over 1 kv head
    of 128) at T = 512 with right-padded lengths (512, 300): the masked
    flash kernel dispatches on the card, the masked plain attention runs on
    the CPU, and the hidden states on valid positions agree to 1e-4."""
    cfg = LlamaConfig(vocab_size=1000, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    model = LlamaBackbone(cfg, device="cuda").init_random(gen)
    cpu_model = LlamaBackbone(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t, lengths = 512, (512, 300)
    ids = torch.randint(0, cfg.vocab_size, (len(lengths), t), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]).int()
    reset_counts()
    with torch.no_grad():
        a = model(ids, mask)
        torch.cuda.synchronize()
        launched = launch_counts()["flash_masked"]
        b = cpu_model(ids.cpu(), mask.cpu())
    a = a.cpu()
    err = max((a[:, i, :n] - b[:, i, :n]).abs().max().item() for i, n in enumerate(lengths))
    scale = max(b[:, i, :n].abs().max().item() for i, n in enumerate(lengths))
    log(f"small fp32 Llama (2 layers, 256 wide, T {t}, lengths {lengths}), card vs CPU: "
        f"max_abs_err {err:.3e} on valid positions (tol 1e-4, max|ref| {scale:.3e}), "
        f"flash_masked launches {launched} (expected {cfg.num_layers})")
    if not err <= 1e-4 or launched != cfg.num_layers:
        raise SystemExit("the small Llama on the card disagrees with the CPU")


# the audio path's input: 48 kHz stereo, as the production study's wav files
AUDIO_SR = 48000
# limit of the small audio check (relative L2 of the features): the bf16
# conformer on both sides, the card's relative-key kernel against the CPU's
# plain attention, cuBLAS against the CPU's bf16 GEMMs, cuFFT against
# pocketfft in the mel (first reading on an H100: 1.945e-3; a pad mask
# gone wrong reads of order 1)
AUDIO_CPU_TOL = 5e-3


def speech_like(n: int, sr: int, rng: np.random.Generator) -> np.ndarray:
    """An AM-modulated harmonic stack over a noise floor (a voiced-speech
    stand-in, the generator of the JAX package's resampling tests)."""
    t = np.arange(n) / sr
    f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.5 * t))
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 9))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def stereo_chunks(durations, sr: int, seed: int) -> list[tuple[np.ndarray, int, float]]:
    """A seeded stereo speech-like signal cut into consecutive chunks of
    ``durations`` seconds, each z-scored to mono as the feature reads a
    ``Sound`` event: ``(wav, sr, duration)``."""
    rng = np.random.default_rng(seed)
    sizes = [int(round(d * sr)) for d in durations]
    stereo = np.stack([speech_like(sum(sizes), sr, rng) for _ in range(2)], axis=1)
    starts = np.cumsum([0] + sizes)
    return [(mono_zscore(stereo[a : a + n]), sr, d) for a, n, d in zip(starts, sizes, durations)]


@torch.no_grad()
def check_small_audio_against_cpu() -> None:
    """A small bf16 w2v-BERT at head dim 64 (2 layers, 128 wide, the
    relative-key kernel's configuration) on the card and on the CPU from
    the same weights: two 48 kHz chunks through ``encode_sound_stream``
    (resampled, padded to the 5 s bucket, so the pad masks run) must give
    the same features, the card launching the kernel once a layer and
    chunk."""
    cfg = Wav2VecBertConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                            conv_kernel_size=7, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    model = Wav2VecBertBackbone(cfg, device="cuda").init_random(gen)
    cpu_model = Wav2VecBertBackbone(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    chunks = stereo_chunks((2.7, 4.1), AUDIO_SR, SEED + 16)
    reset_counts()
    gpu = list(encode_sound_stream(TorchAudioBackbone(model), chunks))
    launched = launch_counts()["flash_relkey"]
    cpu = list(encode_sound_stream(TorchAudioBackbone(cpu_model, device="cpu"), chunks))
    same = [a.shape for a in gpu] == [b.shape for b in cpu]
    rel = (np.sqrt(sum(np.square(a - b).sum() for a, b in zip(gpu, cpu)))
           / np.sqrt(sum(np.square(b).sum() for b in cpu))) if same else float("inf")
    log(f"small bf16 w2v-BERT (2 layers, 128 wide, head dim 64, 48 kHz chunks of 2.7 and 4.1 s in 5 s "
        f"buckets), card vs CPU: rel L2 {rel:.3e} (tol {AUDIO_CPU_TOL:.0e}), flash_relkey launches {launched}, "
        f"shapes {[a.shape for a in gpu]}")
    if not same or not rel <= AUDIO_CPU_TOL or launched != cfg.num_layers * len(chunks):
        raise SystemExit("the small w2v-BERT on the card disagrees with the CPU, or did not run its kernel")


def plain_features(encode, windows: np.ndarray) -> np.ndarray:
    """``encode(windows)`` with every kernel of the backbone swapped for its
    plain version on the card: the same model, scales and inputs."""
    reset_counts()
    with mock.patch.multiple(vjepa2, flash_attention=flash.bounded_attention_plain,
                             int8_matmul_fused=quant.int8_matmul_fused_plain,
                             int8_mlp_fused=quant.int8_mlp_fused_plain):
        out = encode(windows)
    launched = {**flash.launch_counts, **quant.launch_counts}
    if any(launched.values()):
        raise SystemExit(f"the plain reference launched kernels: {launched}")
    return out


def video_path(n_windows: int = 10, window_batch: int = 4) -> dict:
    """The video path at full ViT-G width and depth through the kernels."""
    cfg = dataclasses.replace(VJEPA2_VITG, quantize=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t0 = time.perf_counter()
    model = quantized_backbone(cfg, gen)
    reset_counts()
    model = _calibrated_static_model(model, cfg.frames_per_clip, cfg.crop_size)
    torch.cuda.synchronize()
    calib = launch_counts()
    log(f"ViT-G built and calibrated in {time.perf_counter() - t0:.1f} s; calibration launches {calib}")
    if calib != {**{key: 0 for key in calib}, "flash_attention": cfg.num_layers}:
        raise SystemExit("calibration did not launch the kernels as expected")
    backbone = TorchVideoBackbone(model, n_frames=cfg.frames_per_clip, crop_size=cfg.crop_size)
    rng = np.random.default_rng(SEED + 6)
    windows = [rng.integers(0, 256, (cfg.frames_per_clip, 288, 512, 3), dtype=np.uint8)
               for _ in range(n_windows)]
    batch_s = []
    encode, encode_async = backbone.encode_windows, backbone.encode_windows_async

    def timed(batch):
        t = time.perf_counter()
        out = encode_async(batch).cpu()  # one batch at a time, its states back on the host
        batch_s.append(time.perf_counter() - t)
        return out

    backbone.encode_windows_async = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    feats = encode_window_stream(backbone, windows, window_batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    backbone.encode_windows_async = encode_async
    # the stream as the feature runs it: two batches in flight
    t0 = time.perf_counter()
    pipelined = encode_window_stream(backbone, windows, window_batch)
    stream_s = time.perf_counter() - t0
    reset_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-n_windows // window_batch)
    expected = {**{key: 0 for key in launches}, "flash_attention": cfg.num_layers * n_batches,
                "w8a8": 2 * cfg.num_layers * n_batches, "w8a8_rope": 2 * cfg.num_layers * n_batches,
                "int8_mlp": cfg.num_layers * n_batches}
    trunk_input = aggregate_layers(feats, [0.5, 0.75, 1.0])
    log(f"video features {feats.shape}, trunk input {trunk_input.shape}; batch seconds {batch_s}; "
        f"the stream with two batches in flight: {stream_s:.3f} s for {n_batches} batches, "
        f"max |diff| to batch by batch {np.abs(pipelined - feats).max():.3e}")
    if not np.abs(pipelined - feats).max() <= 1e-5 * np.abs(feats).max():
        raise SystemExit("the pipelined window stream gave other features than batch by batch")
    log(f"video launches {launches} (expected {expected}); peak device memory {peak_gb:.2f} GB")
    want = (cfg.num_layers + 1, cfg.hidden_size, n_windows)
    if feats.shape != want or not np.isfinite(feats).all():
        raise SystemExit(f"video features: shape {feats.shape} (want {want}) or non-finite values")
    if trunk_input.shape != (2, cfg.hidden_size, n_windows) or not np.isfinite(trunk_input).all():
        raise SystemExit(f"aggregate_layers gave {trunk_input.shape} or non-finite values")
    if launches != expected:
        raise SystemExit("the video path did not launch the kernels as expected")
    kernels = profile_run(f"one ViT-G window batch of {window_batch}",
                          lambda: encode(np.stack(windows[:window_batch])), statistics.mean(batch_s[1:]) * 1e3, top=12)
    parts = parts_ms(kernels, 1, {"quantize passes": "quantize_kernel", "row 6 GEMM": "StoreDequant<__nv_bfloat16, 0>",
                                  "fc1": "StoreGeluQuant", "fc2": "StoreDequant<__nv_bfloat16, 1>"})
    log("int8 kernels of the window batch under the profiler: "
        + ", ".join(f"{part} {ms:.3f} ms" for part, ms in parts.items()))

    # the first batch again through the plain versions: cosine and relative
    # L2 of each window's token-pooled feature vector, layer by layer
    t0 = time.perf_counter()
    ref = plain_features(encode, np.stack(windows[:window_batch])).astype(np.float64)
    got = feats[:, :, :window_batch].transpose(2, 0, 1).astype(np.float64)  # (B, L+1, D)
    norms = np.linalg.norm(ref, axis=-1)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * norms)
    rel = np.linalg.norm(got - ref, axis=-1) / norms
    log(f"video features, kernels vs plain on the card ({window_batch} windows, "
        f"{time.perf_counter() - t0:.1f} s): min cosine {cos.min():.7f} (tol 0.9999), "
        f"max rel L2 {rel.max():.3e} (tol 1e-2) at layer {int(rel.max(axis=0).argmax())}, "
        f"last layer {rel[:, -1].max():.3e}")
    if not (cos.min() >= 0.9999 and rel.max() <= 1e-2):
        raise SystemExit("the video features through the kernels disagree with the plain versions")
    return {"launches": launches, "batch_s": statistics.mean(batch_s[1:]), "peak_gb": peak_gb,
            "windows": windows, "window_batch": window_batch, "first_batch": got}


def transcript(n_words: int, context_cap: int, seed: int) -> list[tuple[str, str]]:
    """A seeded transcript of lowercase words, each with its rolling left
    context (itself included) capped at ``context_cap`` words, as
    AddContextToWords builds them."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(2, 10))) for _ in range(5000)]
    text = [vocab[i] for i in rng.integers(0, len(vocab), n_words)]
    return [(w, " ".join(text[max(0, i + 1 - context_cap) : i + 1])) for i, w in enumerate(text)]


def pooled_agreement(got: np.ndarray, ref: np.ndarray) -> tuple[float, np.ndarray]:
    """The min cosine of the (word, layer) feature vectors, and their max
    relative L2 layer by layer."""
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    norms = np.linalg.norm(ref, axis=-1)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * norms)
    return cos.min(), (np.linalg.norm(got - ref, axis=-1) / norms).max(axis=0)


def compare_pooled(got: np.ndarray, ref: np.ndarray, what: str, dtype: torch.dtype,
                   pair: str = "kernel vs plain") -> bool:
    """Whether the features through the kernel keep TEXT_LIMITS[dtype]
    against those through the plain attention (or another ``pair``)."""
    cos, rel = pooled_agreement(got, ref)
    cos_tol, rel_tol = TEXT_LIMITS[dtype]
    log(f"text features {str(dtype)[6:]}, {pair} on the card ({what}): min cosine "
        f"{cos:.7f} (tol {cos_tol}), max rel L2 {rel.max():.3e} (tol {rel_tol:.0e}) at layer "
        f"{int(rel.argmax())}; by layer {' '.join(f'{r:.1e}' for r in rel)}")
    return cos >= cos_tol and rel.max() <= rel_tol


# limits of the pooled text features through the kernel against the plain
# attention, on the same model and inputs, set from the first readings on
# an H100 (PERF.md).  bf16: min cosine 0.99899, max rel L2 4.5e-2 at
# layer 28; the difference is one bf16 rounding of p under another shift,
# and it grows with depth like the difference between two plain versions
# that differ only in rounding p.  fp32: the order of the sums alone
TEXT_LIMITS = {torch.bfloat16: (0.998, 8e-2), torch.float32: (0.9999999, 1e-4)}


@torch.no_grad()
def text_path(n_words: int = 1280, batch_size: int = 8, context_cap: int = 1024) -> dict:
    """The text path at full Llama-3.2-3B width and depth through the kernel."""
    cfg = LLAMA_3P2_3B
    # free the video path's ViT-G (held in a reference cycle), so that the
    # peak is this path's
    gc.collect()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    t0 = time.perf_counter()
    model = LlamaBackbone(cfg, device="cuda").init_random(gen)
    n_params = sum(p.numel() for p in model.parameters())
    backbone = TorchTextBackbone(model, HashTokenizer(cfg.vocab_size), pad_id=0)
    words = transcript(n_words, context_cap, SEED + 11)
    torch.cuda.synchronize()
    log(f"Llama-3.2-3B built in {time.perf_counter() - t0:.1f} s: {n_params} params")

    # the forwards as reckoned from the bucket tables: the first context_cap
    # words are one chain in CHAIN_CHUNK-word chunks, the sliding rest are
    # padded batches; each forward of width >= 256 (a multiple of 128)
    # launches the kernel once per layer
    buckets = TorchTextBackbone.BUCKETS
    widths = [(1, _bucket_width(min(k + CHAIN_CHUNK, context_cap), buckets))
              for k in range(0, context_cap, CHAIN_CHUNK)]
    widths += [(batch_size, _bucket_width(context_cap, buckets))] * ((n_words - context_cap) // batch_size)
    expected = cfg.num_layers * sum(w >= 256 and w % 128 == 0 for _, w in widths)

    forward, forwards = backbone._forward, []

    def timed_forward(ids, mask):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(ids, mask)
        end.record()
        forwards.append((ids.shape, start, end))
        return out

    backbone._forward = timed_forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    feats = np.stack(list(encode_word_stream(backbone, words, batch_size, max_context_tokens=1024)))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    backbone._forward = forward
    shapes = [tuple(shape) for shape, _, _ in forwards]
    batch_ms = [s.elapsed_time(e) for shape, s, e in forwards if tuple(shape) == (batch_size, 1024)]
    trunk_input = aggregate_layers(feats.transpose(1, 2, 0), [0.5, 0.75, 1.0])
    log(f"text features {feats.shape}, trunk input {trunk_input.shape}; forwards {shapes}")
    log(f"text path: {wall_s:.2f} s for {n_words} words ({wall_s / n_words * 1e3:.3f} ms a word); "
        f"(8, 1024) batch forwards {[round(ms, 2) for ms in batch_ms]} ms; peak {peak_gb:.2f} GB")
    log(f"text launches {launches} (expected flash_masked {expected})")
    want = (n_words, cfg.num_layers + 1, cfg.hidden_size)
    if feats.shape != want or not np.isfinite(feats).all():
        raise SystemExit(f"text features: shape {feats.shape} (want {want}) or non-finite values")
    if trunk_input.shape != (2, cfg.hidden_size, n_words) or not np.isfinite(trunk_input).all():
        raise SystemExit(f"aggregate_layers gave {trunk_input.shape} or non-finite values")
    if shapes != widths:
        raise SystemExit(f"the text path ran forwards {shapes}, reckoned {widths}")
    if launches != {**{key: 0 for key in launches}, "flash_masked": expected}:
        raise SystemExit("the text path did not launch the kernels as expected")

    # the last chain chunk (width 1024) and the first padded batch again
    # with the plain attention: the same model, tokens and spans
    chunk = words[context_cap - CHAIN_CHUNK : context_cap]
    batch = words[context_cap : context_cap + batch_size]
    reset_counts()
    with mock.patch.object(llama, "flash_attention", flash.flash_attention_plain):
        toks = backbone.chain_tokenize([c for _, c in chunk])
        chain_ref = np.asarray(backbone.pooled_states_chain_async(toks, [len(w) for w, _ in chunk]))
        ids, mask = backbone.encode_pretokenized(backbone.chain_tokenize([c for _, c in batch]), 1024)
        spans = np.array([max(1, min(len(w), int(n))) for (w, _), n in zip(batch, mask.sum(-1))], np.int32)
        batch_ref = backbone.pooled_states(ids, mask, spans)
    # a yardstick for the bf16 limits: two plain versions that differ only
    # in rounding p to bf16 before P.V (v widened to fp32 keeps p in fp32)
    with mock.patch.object(llama, "flash_attention", lambda q, k, v, causal, lengths:
                           flash.flash_attention_plain(q, k, v.float(), causal, lengths)):
        unrounded = backbone.pooled_states(ids, mask, spans)
    rel = pooled_agreement(unrounded.transpose(1, 0, 2), batch_ref.transpose(1, 0, 2))[1]
    log(f"text features bfloat16, plain vs plain with p unrounded (first (8, 1024) batch): "
        f"max rel L2 by layer {' '.join(f'{r:.1e}' for r in rel)}")
    if any(launch_counts().values()) or ids.shape != (batch_size, 1024):
        raise SystemExit(f"the plain reference launched {launch_counts()} or ran at {ids.shape}")
    agree = [compare_pooled(feats[context_cap - CHAIN_CHUNK : context_cap],
                            chain_ref[:, :CHAIN_CHUNK].transpose(1, 0, 2), "last chain chunk, width 1024",
                            cfg.dtype),
             compare_pooled(feats[context_cap : context_cap + batch_size], batch_ref.transpose(1, 0, 2),
                            "first (8, 1024) batch", cfg.dtype)]

    # the same batch through the model in fp32 (the bf16 weights, widened
    # exactly), where kernel and plain attention differ in the order of sums
    model32 = LlamaBackbone(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    model32.load_state_dict(model.state_dict())
    backbone32 = TorchTextBackbone(model32, HashTokenizer(cfg.vocab_size), pad_id=0)
    got32 = backbone32.pooled_states(ids, mask, spans)
    reset_counts()
    with mock.patch.object(llama, "flash_attention", flash.flash_attention_plain):
        ref32 = backbone32.pooled_states(ids, mask, spans)
    if any(launch_counts().values()):
        raise SystemExit(f"the plain reference launched {launch_counts()}")
    agree.append(compare_pooled(got32.transpose(1, 0, 2), ref32.transpose(1, 0, 2),
                                "first (8, 1024) batch", torch.float32))
    if not all(agree):
        raise SystemExit("the text features through the kernel disagree with the plain attention")
    return {"launches": launches, "batch_ms": statistics.mean(batch_ms[1:]),
            "word_ms": wall_s / n_words * 1e3, "peak_gb": peak_gb}


# limits of each bench variant against ``fast`` on the (1, 2)-head slice
# (max-abs, mean relative): default and bounded run the fast kernel's
# function with fp32 scores, so they must be equal to it; the others ~4x
# the first readings on an H100 (PERF.md: fastb16 9.8e-4 / 4.3e-3, packed
# 4.9e-4 / 2.3e-5; one bf16 ulp at the outputs' ~0.2 is 9.8e-4)
BENCH_ERR = {"default": (0.0, 0.0), "bounded": (0.0, 0.0), "fastb16": (4e-3, 2e-2), "packed": (2e-3, 1e-4)}


def bench_path() -> dict:
    """The attention bench's entry point with every variant at its full shape."""
    reset_counts()
    result = bench_attn.run(["all"])
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = {**{key: 0 for key in launches}, **result["launches"]}
    log(f"bench launches {launches} (reckoned {expected})")
    if launches != expected:
        raise SystemExit("the attention bench did not launch the kernels as it reckons")
    ok = True
    for name, (max_abs, mean_rel) in result["err"].items():
        limit = BENCH_ERR[name]
        held = max_abs <= limit[0] and mean_rel <= limit[1]
        log(f"bench {name} vs fast: max_abs {max_abs:.3e} (tol {limit[0]:.0e}), mean_rel {mean_rel:.3e} "
            f"(tol {limit[1]:.0e}) {'ok' if held else 'FAIL'}")
        ok = ok and held
    if not ok or sorted(result["err"]) != sorted(BENCH_ERR):
        raise SystemExit("a bench variant disagrees with the fast kernel")
    return {"launches": launches, "ms": result["ms"]}


# the production ChunkEvents range (grids/defaults.py: Sound chunks of
# 30-60 s) as five chunks; their 5 s buckets at 16 kHz
AUDIO_CHUNKS_S = (30.0, 38.3, 44.9, 52.6, 60.0)
AUDIO_BUCKETS = (480000, 640000, 720000, 880000, 960000)
# limits of the bucketed against the exact-length call of one chunk: per
# layer relative L2 and min cosine of the (D, n_out) features, ~2.5x the
# first reading on an H100 (PERF.md: 1.9e-2 at layer 18, cosine 0.99979).
# Layer 0 differs by 2.9e-5 (the masked mel statistics); each bf16 layer
# adds roundings under other matmul shapes, carried up by the random weights
AUDIO_BUCKET_LIMITS = (5e-2, 0.999)


def w2v_flops(cfg: Wav2VecBertConfig, t: int) -> float:
    """Matmul operations of one forward over ``t`` frames: the feature
    projection, then per layer the two FFNs, q/k/v/out, scores and P.V,
    the distance projection and the conv module."""
    h, f, k = cfg.hidden_size, cfg.intermediate_size, cfg.conv_kernel_size
    n_pos = cfg.left_max_pos + cfg.right_max_pos + 1
    layer = 8 * t * h * f + 8 * t * h * h + 4 * t * t * h + 2 * t * n_pos * h + 6 * t * h * h + 2 * t * h * k
    return 2 * t * cfg.input_dim * h + cfg.num_layers * layer


def profile_run(label: str, run, unprofiled_ms: float, top: int = 10) -> list[tuple[str, float, int]]:
    """``run()`` again under ``torch.profiler``: the device time of its
    kernels by name, and their sum against the same work's unprofiled host
    time (the device-busy share; the rest is the device's idle share).
    Returns (name, device ms in all, launches) of every kernel."""
    kernels = kernel_tools.device_kernels(run)
    busy_ms = sum(ms for _, ms, _ in kernels)
    log(f"{label} under torch.profiler: device kernels {busy_ms:.3f} ms in "
        f"{sum(count for _, _, count in kernels)} launches, {busy_ms / unprofiled_ms:.3f} of the unprofiled "
        f"{unprofiled_ms:.3f} ms; top kernels by device time:")
    for key, ms, count in sorted(kernels, key=lambda kernel: kernel[1], reverse=True)[:top]:
        log(f"  {ms:9.3f} ms {count:6d}x  {key[:100]}")
    return kernels


@torch.no_grad()
def audio_path(peaks: dict[str, float]) -> dict:
    """The audio path at full w2v-BERT 2.0 width and depth."""
    cfg = W2V_BERT_2_0
    # the earlier paths' models sit in reference cycles (a backbone holding
    # its own timed bound method); free them so the peak is this path's
    gc.collect()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    t0 = time.perf_counter()
    model = Wav2VecBertBackbone(cfg, device="cuda").init_random(gen)
    n_params = sum(p.numel() for p in model.parameters())
    backbone = TorchAudioBackbone(model)
    chunks = stereo_chunks(AUDIO_CHUNKS_S, AUDIO_SR, SEED + 12)
    torch.cuda.synchronize()
    log(f"w2v-BERT 2.0 built in {time.perf_counter() - t0:.1f} s: {n_params} params; chunks of "
        f"{AUDIO_CHUNKS_S} s of 48 kHz stereo")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    feats, chunk_s = [], []
    t0 = time.perf_counter()
    # each chunk opens a bucket (it runs eagerly, then the bucket's graph is
    # captured); the 60 s chunk again at the end replays its bucket's graph
    for latents in encode_sound_stream(backbone, [*chunks, chunks[-1]]):  # each ends in a copy to the host
        chunk_s.append(time.perf_counter() - t0)
        feats.append(latents)
        t0 = time.perf_counter()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replayed, replay_ms = feats.pop(), chunk_s.pop() * 1e3
    n_outs = [max(1, int(np.round(d * 2))) for d in AUDIO_CHUNKS_S]
    trunk_input = np.concatenate([aggregate_layers(f, [0.5, 0.75, 1.0]) for f in feats], axis=-1)
    ms_chunk = statistics.mean(chunk_s[1:]) * 1e3
    per_hour = sum(chunk_s[1:]) / sum(AUDIO_CHUNKS_S[1:]) * 3600
    frames = 1 + (AUDIO_BUCKETS[-1] - 400) // 160
    flops = w2v_flops(cfg, frames // 2)
    log(f"audio features {[f.shape for f in feats]}, trunk input {trunk_input.shape}; buckets "
        f"{sorted(backbone.bucket_shapes)}; chunk seconds {[round(x, 4) for x in chunk_s]}")
    log(f"audio path: {ms_chunk:.2f} ms per chunk that opens a bucket (first excluded), {per_hour:.3f} s per "
        f"hour of audio, the 60 s chunk replayed {replay_ms:.2f} ms, peak {peak_gb:.2f} GB; a 60 s chunk is "
        f"{flops / 1e12:.3f} TFLOP, {1e3 * flops / peaks['bfloat16']:.3f} ms at the bf16 peak; launches "
        f"{launches}; graphs {backbone.counts}")
    want = [(cfg.num_layers + 1, cfg.hidden_size, n) for n in n_outs]
    if [f.shape for f in feats] != want or not all(np.isfinite(f).all() for f in feats):
        raise SystemExit(f"audio features: shapes {[f.shape for f in feats]} (want {want}) or non-finite values")
    if trunk_input.shape != (2, cfg.hidden_size, sum(n_outs)) or not np.isfinite(trunk_input).all():
        raise SystemExit(f"aggregate_layers gave {trunk_input.shape} or non-finite values")
    # row 8 runs once a layer in every forward, eager or replayed (a capture
    # launches nothing, and each replay counts what its capture recorded)
    expected = {**{key: 0 for key in launches}, "flash_relkey": cfg.num_layers * (len(chunks) + 1)}
    graphs = {key: backbone.counts[key] for key in ("graph_captures", "graph_replays")}
    if graphs != {"graph_captures": len(chunks), "graph_replays": 1}:
        raise SystemExit(f"the audio path gave {graphs} over {len(chunks)} buckets, not one capture a bucket "
                         f"and one replay")
    if not np.array_equal(replayed, feats[-1]):
        raise SystemExit("the replayed 60 s chunk differs from its eager run")
    if sorted(b for b, _ in backbone.bucket_shapes) != list(AUDIO_BUCKETS) or launches != expected:
        raise SystemExit(f"the audio path ran other buckets than reckoned, or launched {launches}, not {expected}")

    profile_run(f"audio {chunks[-1][2]} s chunk, replayed", lambda: list(encode_sound_stream(backbone, [chunks[-1]])),
                replay_ms)

    # the 38.3 s chunk again at its exact length: the padding is masked out
    wav, sr, _ = chunks[1]
    exact = backbone.hidden_states_2hz(resample_poly(torch.from_numpy(wav).cuda(), sr, TARGET_SR), n_outs[1])
    got, ref = feats[1].astype(np.float64), exact.astype(np.float64)
    rel = np.linalg.norm(got - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    rel_tol, cos_tol = AUDIO_BUCKET_LIMITS
    log(f"audio 38.3 s chunk, bucketed (40 s) vs exact length: max rel L2 {rel.max():.3e} "
        f"(tol {rel_tol:.0e}) at layer {int(rel.argmax())}, min cosine {cos.min():.6f} (tol {cos_tol}); "
        f"by layer {' '.join(f'{r:.1e}' for r in rel)}")
    if not (rel.max() <= rel_tol and cos.min() >= cos_tol):
        raise SystemExit("the bucketed audio features disagree with the exact-length call")
    return {"ms_chunk": ms_chunk, "replay_ms": replay_ms, "per_hour": per_hour, "peak_gb": peak_gb,
            "n_params": n_params, "backbone": backbone, "launches": launches}


FLAGSHIP_DIMS = {"text": (2, 3072), "audio": (2, 1024), "video": (2, 1408)}
METRICS = [
    {"log_name": "pearson", "name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 1000}},
    {"log_name": "subj_pearson", "name": "GroupedMetric",
     "metric_name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 1000}},
    {"log_name": "retrieval_top1", "name": "TopkAcc", "topk": 1},
]
OPTIM = {
    "optimizer": {"name": "Adam", "lr": 1e-4,
                  "kwargs": {"weight_decay": 0.0, "mu_dtype": "bfloat16"}},
    "scheduler": {"name": "OneCycleLR", "kwargs": {"max_lr": 1e-4, "pct_start": 0.1}},
}


def make_trainer(feature_dims, n_outputs, device=None, metrics=(), optim=OPTIM, loss="MSELoss",
                 mesh=None, **model_kw):
    cfg = FmriEncoderConfig(
        n_subjects=4, modality_dropout=0.3, remat=True, contrastive_enabled=True,
        contrastive_modalities=["video"], **model_kw,
    )
    model = cfg.build(feature_dims, n_outputs=n_outputs, n_output_timesteps=100)
    return BrainTrainer(
        model=model,
        loss_fn=build_loss({"name": loss}),
        optim_config=OptimConfig(**optim),
        metrics={f"val/{m['log_name']}": build_metric(m, n_groups=4) for m in metrics},
        config=TrainerConfig(n_epochs=1, folder=None, save_checkpoints=False, seed=SEED,
                             contrastive_weight=0.1),
        device=device,
        mesh=mesh,
    )


def make_batch(feature_dims, n_outputs, b, t, gen, device="cuda"):
    data = {
        m: torch.randn((b, n_layers, d, t), generator=gen, device=device)
        for m, (n_layers, d) in feature_dims.items()
    }
    data["subject_id"] = torch.randint(0, 4, (b, 1), generator=gen, device=device)
    data["fmri"] = torch.randn((b, n_outputs, 100), generator=gen, device=device)
    return SegmentData(data=data, segments=[None] * b)


def check_small_against_cpu() -> None:
    """A small trunk trained 3 steps on the card (through the kernel) and on
    the CPU (plain version) from the same weights: losses agree to 1e-4."""
    dims = {"text": (2, 40), "audio": (2, 16), "video": (2, 24)}
    small = dict(hidden=96, depth=2, heads=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [make_batch(dims, 20, 4, 200, gen) for _ in range(3)]
    gpu = make_trainer(dims, 20, **small)
    cpu = make_trainer(dims, 20, device="cpu", **small)
    gpu.init_state(batches[0], total_steps=3)
    cpu.init_state(batches[0], total_steps=3)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    worst = 0.0
    for batch in batches:
        lg = gpu.train_step(batch.data)[0].item()
        lc = cpu.train_step({k: v.cpu() for k, v in batch.data.items()})[0].item()
        worst = max(worst, abs(lg - lc) / abs(lc))
    log(f"small trunk, 3 steps, card vs CPU: max rel loss diff {worst:.3e} (tol 1e-4)")
    if not worst <= 1e-4:
        raise SystemExit("the small trunk on the card disagrees with the CPU")


def check_prefetch(n_batches: int = 3) -> None:
    """Host batches of the flagship's shapes through ``prefetch_to_device``
    onto the card: equal on arrival, kept by ``to_device``; an early stop
    of the consumer ends the producer thread."""
    rng = np.random.default_rng(SEED)
    b, t = 16, 298
    host = []
    for _ in range(n_batches):
        data = {m: rng.random((b, n_layers, d, t), dtype=np.float32)
                for m, (n_layers, d) in FLAGSHIP_DIMS.items()}
        data["subject_id"] = rng.integers(0, 4, (b, 1))
        data["fmri"] = rng.random((b, 1000, 100), dtype=np.float32)
        host.append(SegmentData(data=data, segments=[None] * b))
    nbytes = sum(v.nbytes for v in host[0].data.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(prefetch_to_device(iter(host), "cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for batch, ref in zip(got, host):
        for key, value in ref.data.items():
            if not (batch.data[key].is_cuda and torch.equal(batch.data[key].cpu(),
                                                            torch.from_numpy(value))):
                raise SystemExit(f"prefetch_to_device changed {key!r} on its way to the card")
    if to_device(got[0].data, "cuda")["fmri"] is not got[0].data["fmri"]:
        raise SystemExit("to_device copied a batch that was already on the card")
    before = threading.active_count()
    stream = prefetch_to_device(iter(host), "cuda", size=1)
    next(stream)
    stream.close()
    if threading.active_count() > before:
        raise SystemExit("prefetch_to_device left its producer thread running")
    log(f"prefetch_to_device: {n_batches} flagship host batches of {nbytes / 1e6:.1f} MB "
        f"onto the card in {seconds:.3f} s ({n_batches * nbytes / seconds / 1e9:.2f} GB/s "
        "with the host's pinning), equal on arrival")


def main_path(n_steps: int = 5, n_eval: int = 2, n_predict: int = 1) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = 16, 298
    trainer = make_trainer(FLAGSHIP_DIMS, 1000, metrics=METRICS)
    train = [make_batch(FLAGSHIP_DIMS, 1000, b, t, gen) for _ in range(n_steps)]
    evals = [make_batch(FLAGSHIP_DIMS, 1000, b, t, gen) for _ in range(n_eval + n_predict)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    trainer.init_state(train[0], total_steps=100)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    step_s, losses = [], []
    for batch in train:
        t0 = time.perf_counter()
        loss, aux = trainer.train_step(batch.data)
        losses.append(loss.item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        if not all(np.isfinite([losses[-1], *(v.item() for v in aux.values())])):
            raise SystemExit(f"non-finite train loss {losses[-1]} / {aux}")
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    val = trainer.evaluate(evals[:n_eval], split="val")
    eval_s = time.perf_counter() - t0
    preds = [p for p, _ in trainer.predict(evals[n_eval:])]
    torch.cuda.synchronize()
    launches = dict(attn.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"params {n_params}, train losses {losses}")
    log(f"step seconds {step_s}; median {statistics.median(step_s[1:]):.4f} s (first excluded)")
    log(f"evaluate on {n_eval} batches: {eval_s:.3f} s; metrics {json.dumps(val)}")
    log(f"peak device memory {peak_gb:.2f} GB")
    keys = ["val/loss", "val/pearson", "val/subj_pearson", "val/retrieval_top1"]
    if any(k not in val or not np.isfinite(val[k]) for k in keys):
        raise SystemExit(f"missing or non-finite metrics: {val}")
    if [p.shape for p in preds] != [(b, 1000, 100)] * n_predict or not all(
        np.isfinite(p).all() for p in preds
    ):
        raise SystemExit("predict gave the wrong shape or non-finite values")
    depth = trainer.model.config.depth
    expected = 2 * depth * n_steps + depth * (n_eval + n_predict)  # remat recomputes
    log(f"attention launches {launches['attention']} (expected {expected})")
    if launches["attention"] != expected:
        raise SystemExit("the main path did not launch the attention kernel as expected")
    profile_run("one flagship train step", lambda: trainer.train_step(train[-1].data)[0].item(),
                statistics.median(step_s[1:]) * 1e3, top=15)
    return {"attention": launches["attention"], "step_s": statistics.median(step_s[1:]),
            "peak_gb": peak_gb, "n_params": n_params, "losses": losses,
            "train_peak_gb": train_peak_gb, "steps": len(train)}


# phase 9: the port's Experiment.  The study of the text-only run: the four
# release subjects, 1000 parcels, 10 train episodes of 600 s (about a Friends
# half-episode; the generator adds one test episode).  The hash split keeps 9
# of them for training: 180 windows, 11 full batches of 16, of which the
# StageClock times the 10 after the first, enough for a median
# (MIN_TEXT_STEPS).  The trimodal run's: one subject, two train episodes and
# one test episode of 100 s with video (the shortest at which the last
# contexts pass 128 tokens, so Llama forwards of width 256 launch the text
# kernel)
EXPERIMENT_STUDY = dict(subjects=("sub-01", "sub-02", "sub-03", "sub-05"),
                        train_episodes=tuple(f"e{i:02d}{half}" for i in range(1, 6)
                                             for half in "ab"),
                        duration=600.0, n_parcels=1000, with_video=False)
MIN_TEXT_STEPS = 8
TRIMODAL_STUDY = dict(subjects=("sub-01",), train_episodes=("e01a", "e01b"), duration=100.0,
                      n_parcels=1000, with_video=True)
FEATURES = ("text_feature", "audio_feature", "video_feature")
# limit of the small Experiment, card vs CPU: per-epoch train loss, relative
# (the small trunk's limit of phase 3)
EXPERIMENT_CPU_RTOL = 1e-4
# a checkpoint of the flagship trunk holds its params and Adam moments
# (sizes printed below, PERF.md); an improving epoch writes two (best and
# last) and the end of the fit a third (last, with the SWA weights).  A
# second epoch of the text run would take its writes past what a chip
# machine's disk lets one command write (45 GiB), so it trains one epoch,
# its rerun and the trimodal run write no checkpoint
TEXT_RUN_EPOCHS = 1


class StageClock:
    """Seconds by stage of one ``Experiment.run()`` (events, feature
    prepare, fit, the final evaluate, submission; and the checkpoint writes
    inside fit and reads at a resume), and the (batch size, seconds, data
    wait, enqueue) of each train step inside an epoch after its first: the
    seconds between the ends of consecutive steps (each step waited for),
    what a step costs inside the Experiment, data feed included; the wait
    is the part before the step is called, the card idle for its batch;
    the enqueue is the host's time in ``train_step`` (its launches), the
    rest of the step the card finishing what was enqueued."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.step_s: list[tuple[int, float, float, float]] = []
        self._last_end: float | None = None
        self._in_fit = False

    def _timed(self, stage: str, fn):
        def wrapper(*args, **kwargs):
            inner = stage == "evaluate" and self._in_fit
            self._last_end = None  # an epoch ends with its evaluate
            if stage == "fit":
                self._in_fit = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                if stage == "fit":
                    self._in_fit = False
                if not inner:
                    self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - t0
        return wrapper

    def _step(self, fn):
        def wrapper(trainer, data, *args, **kwargs):
            called = time.perf_counter()
            out = fn(trainer, data, *args, **kwargs)
            returned = time.perf_counter()
            torch.cuda.synchronize()
            now = time.perf_counter()
            if self._last_end is not None:
                self.step_s.append((len(data["fmri"]), now - self._last_end,
                                    called - self._last_end, returned - called))
            self._last_end = now
            return out
        return wrapper

    def run(self, experiment: Experiment) -> tuple[dict, float]:
        patches = [
            mock.patch.object(ExperimentData, "get_events",
                              self._timed("events", ExperimentData.get_events)),
            mock.patch.object(experiment_data, "prepare_features",
                              self._timed("features", experiment_data.prepare_features)),
            mock.patch.object(BrainTrainer, "fit", self._timed("fit", BrainTrainer.fit)),
            mock.patch.object(BrainTrainer, "evaluate",
                              self._timed("evaluate", BrainTrainer.evaluate)),
            mock.patch.object(Experiment, "write_submission",
                              self._timed("submission", Experiment.write_submission)),
            mock.patch.object(BrainTrainer, "train_step", self._step(BrainTrainer.train_step)),
            mock.patch.object(BrainTrainer, "save_checkpoint",
                              self._timed("checkpoint writes", BrainTrainer.save_checkpoint)),
            mock.patch.object(BrainTrainer, "load_checkpoint",
                              self._timed("checkpoint read", BrainTrainer.load_checkpoint)),
        ]
        for patch in patches:
            patch.start()
        t0 = time.perf_counter()
        try:
            out = experiment.run()
            torch.cuda.synchronize()
        finally:
            for patch in patches:
                patch.stop()
        return out, time.perf_counter() - t0


def experiment_config(root: Path, study_path: Path, name: str, modalities=("text",),
                      n_epochs: int = 2) -> dict:
    """``grids/defaults.py``'s config on the card, pointed at a synthetic
    study, with caches and the run under ``root``; the features of the
    other modalities off and InfoNCE on the text when there is no video."""
    cfg = ConfDict(default_config)
    cache = str(root / "cache")
    cfg.update({"infra.folder": str(root / name), "infra.mode": "force", "accelerator": "cuda",
                "data.study.path": str(study_path), "data.study.infra.folder": cache,
                "data.neuro.infra.folder": cache, "wandb_config": None, "n_epochs": n_epochs})
    for feature in FEATURES:
        if feature.split("_")[0] in modalities:
            cfg[f"data.{feature}.infra.folder"] = cache
        else:
            cfg[f"data.{feature}"] = None
    if "video" not in modalities:
        cfg["brain_model_config.contrastive_modalities"] = ["text"]
    return cfg.to_dict()


def check_artifacts(folder: Path, out: dict, what: str, checkpoint: bool = True) -> None:
    """metrics.csv, pearson.npy, last.ckpt (with ``checkpoint``) and
    submission.zip exist, and every number of the run's output, pearson.npy
    and the submission is finite."""
    artifacts = ("metrics.csv", "pearson.npy", "submission.zip") + ("last.ckpt",) * checkpoint
    missing = [a for a in artifacts if not (folder / a).exists()]
    sub = np.load(folder / "submission.npy", allow_pickle=True).item() if not missing else {}
    finite = (all(np.isfinite(v) for v in out.values())
              and not missing and np.isfinite(np.load(folder / "pearson.npy")).all()
              and sub and all(np.isfinite(a).all() for c in sub.values() for a in c.values()))
    log(f"{what}: artifacts {sorted(p.name for p in folder.iterdir())}; submission "
        f"{ {s: len(c) for s, c in sub.items()} } chunks a subject")
    if missing or not finite:
        raise SystemExit(f"{what}: missing artifacts {missing} or non-finite values in {out}")


def seeded_llama() -> TorchTextBackbone:
    """Llama-3.2-3B at full width, seeded weights at the HF init scale."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    model = LlamaBackbone(LLAMA_3P2_3B, device="cuda").init_random(gen)
    return TorchTextBackbone(model, HashTokenizer(LLAMA_3P2_3B.vocab_size), pad_id=0)


def experiment_path(root: Path, llama: TorchTextBackbone, trunk_step_s: float) -> dict:
    """``Experiment(**cfg).run()`` on the card with the default text feature
    at full Llama-3.2-3B width and the flagship trunk; then the rerun from
    the same folders, which must compute no feature."""
    study = make_synthetic_study(root / "data", **EXPERIMENT_STUDY)
    cfg = experiment_config(root, study, "text_run", n_epochs=TEXT_RUN_EPOCHS)
    exp = Experiment(**cfg)
    exp.data.text_feature.set_backbone(llama)
    computed = []
    compute = LLAMA3p2._compute

    def counted(self, events):
        computed.extend(events)
        yield from compute(self, events)

    clock = StageClock()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(LLAMA3p2, "_compute", counted):
        out, total_s = clock.run(exp)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    folder = Path(cfg["infra"]["folder"])
    full = [(sec, wait) for n, sec, wait, _ in clock.step_s if n == exp.data.batch_size]
    n_steps = len(full)
    step_s = statistics.median(sec for sec, _ in full) if full else float("nan")
    idle = sum(wait for _, wait in full) / sum(sec for sec, _ in full) if full else float("nan")
    log(f"Experiment (text, Llama-3.2-3B, flagship trunk, {len(exp._trainer.history)} epochs): "
        f"{total_s:.2f} s; by stage { {k: round(v, 3) for k, v in clock.seconds.items()} }; "
        f"{len(computed)} words computed; (batch, seconds, data wait, enqueue) of the steps "
        f"inside the Experiment {[tuple(round(x, 4) for x in step) for step in clock.step_s]}, median of "
        f"batch {exp.data.batch_size} {step_s:.4f} s against phase 4's {trunk_step_s:.4f} s, "
        f"the card idle on data {idle:.3f} of them; peak {peak_gb:.2f} GB; "
        f"launches {launches}; metrics {json.dumps(out)}")
    check_artifacts(folder, out, "Experiment (text)")
    log(f"checkpoints: {', '.join(f'{p.name} {p.stat().st_size / 1e9:.2f} GB' for p in sorted(folder.glob('*.ckpt')))}")
    if not (computed and launches["attention"] and launches["flash_masked"]):
        raise SystemExit(f"the Experiment computed no feature or launched no attention kernel: {launches}")
    if n_steps < MIN_TEXT_STEPS:
        raise SystemExit(f"the Experiment timed {n_steps} full train steps, fewer than {MIN_TEXT_STEPS}")

    # the rerun from the same folders: the named model is never loaded (no
    # backbone is set), so any feature computed would raise.  It resumes from
    # last.ckpt after its last epoch; saving would only write last.ckpt again
    reset_counts()
    computed.clear()
    again, rerun_clock = Experiment(**dict(cfg, save_checkpoints=False)), StageClock()
    with mock.patch.object(LLAMA3p2, "_compute", counted):
        out2, rerun_s = rerun_clock.run(again)
    rerun = launch_counts()
    log(f"Experiment rerun from the same folders: {rerun_s:.2f} s; by stage "
        f"{ {k: round(v, 3) for k, v in rerun_clock.seconds.items()} }; {len(computed)} words "
        f"computed, launches {rerun}, metrics {json.dumps(out2)}")
    check_artifacts(folder, out2, "Experiment rerun")
    if computed or rerun["flash_masked"] or not rerun["attention"]:
        raise SystemExit("the rerun computed features or launched the text kernel")
    return {"seconds": clock.seconds, "total_s": total_s, "step_s": step_s, "peak_gb": peak_gb,
            "launches": launches, "n_steps": n_steps, "idle": idle, "study": study,
            "step_range": (min(sec for sec, _ in full), max(sec for sec, _ in full))}


def check_small_experiment_against_cpu(root: Path) -> None:
    """A small Experiment (tiny trunk, tiny text backbone) on the card and on
    the CPU, from the same trunk and backbone weights: the per-epoch train
    losses agree."""
    study = make_synthetic_study(root / "data", subjects=("sub-01", "sub-02"), n_parcels=32,
                                 duration=40.0, with_video=False)
    cpu_text = TinyTextBackbone(device="cpu")
    card_text = TinyTextBackbone(state_dict=cpu_text.model.state_dict(), device="cuda")
    init = {}
    orig = BrainTrainer.init_state

    def init_state(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        if init:
            self.model.load_state_dict({k: v.to(self.device) for k, v in init.items()})
        else:
            init.update({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()})

    histories = {}
    for device, backbone in (("cuda", card_text), ("cpu", cpu_text)):
        cfg = ConfDict(experiment_config(root / device, study, "run"))
        cfg.update({"accelerator": device, "data.num_workers": 0, "data.batch_size": 4,
                    "data.text_feature.model_name": "tiny-random",
                    "data.text_feature.device": device, "brain_model_config.hidden": 96,
                    "brain_model_config.depth": 1, "brain_model_config.heads": 4,
                    "brain_model_config.modality_dropout": 0.0,
                    "metrics": [{"log_name": "pearson", "name": "MultidimPearsonCorrCoef"}]})
        exp = Experiment(**cfg.to_dict())
        exp.data.text_feature.set_backbone(backbone)
        with mock.patch.object(BrainTrainer, "init_state", init_state):
            exp.run()
        histories[device] = [r["train/loss"] for r in exp._trainer.history]
    got, want = np.array(histories["cuda"]), np.array(histories["cpu"])
    rel = np.abs(got - want).max() / np.abs(want).max()
    log(f"small Experiment (tiny trunk and text backbone, {len(want)} epochs), card vs CPU: "
        f"train losses {got.tolist()} / {want.tolist()}, max rel diff {rel:.3e} "
        f"(tol {EXPERIMENT_CPU_RTOL:.0e})")
    if got.shape != want.shape or not len(want) or not rel <= EXPERIMENT_CPU_RTOL:
        raise SystemExit("the small Experiment on the card disagrees with the CPU")


def audio_feature_path(root: Path, backbone: TorchAudioBackbone) -> None:
    """The pydantic ``Wav2VecBert`` at full w2v-BERT 2.0 width over ``Sound``
    events of a wav written by ``io/wav``: phase 8's chunk durations, one
    stereo 48 kHz file, each event at its offset.  Each chunk's features
    must agree with ``encode_sound_stream`` on the same samples within
    phase 8's limits; a second feature over the same cache computes none."""
    rng = np.random.default_rng(SEED + 22)
    n = int(round(sum(AUDIO_CHUNKS_S) * AUDIO_SR))
    stereo = np.stack([speech_like(n, AUDIO_SR, rng) for _ in range(2)], axis=1)
    path = root / "speech.wav"
    path.parent.mkdir(parents=True, exist_ok=True)
    wavio.write(path, 0.3 * stereo / np.abs(stereo).max(), AUDIO_SR)
    offsets = np.cumsum([0.0, *AUDIO_CHUNKS_S[:-1]])
    events = [Sound(filepath=str(path), start=float(o), offset=float(o), duration=d,
                    timeline="audio") for o, d in zip(offsets, AUDIO_CHUNKS_S)]
    feature = Wav2VecBert(infra={"folder": str(root / "cache")})
    feature.set_backbone(backbone)
    t0 = time.perf_counter()
    got = feature._get_data(events)
    seconds = time.perf_counter() - t0
    rel_tol, cos_tol = AUDIO_BUCKET_LIMITS
    worst_rel, worst_cos = 0.0, 1.0
    for event, g in zip(events, got):
        sr = int(event.frequency)
        wav = mono_zscore(wavio.read(str(path), start=int(round(event.offset * sr)),
                                     frames=int(round(event.duration * sr))))
        (ref,) = encode_sound_stream(backbone, [(wav, sr, event.duration)])
        g64, r64 = np.asarray(g, np.float64), ref.astype(np.float64)
        if g64.shape != r64.shape:
            raise SystemExit(f"Wav2VecBert gave {g64.shape}, encode_sound_stream {r64.shape}")
        rel = np.linalg.norm(g64 - r64, axis=(1, 2)) / np.linalg.norm(r64, axis=(1, 2))
        cos = (g64 * r64).sum(1) / (np.linalg.norm(g64, axis=1) * np.linalg.norm(r64, axis=1))
        worst_rel, worst_cos = max(worst_rel, rel.max()), min(worst_cos, cos.min())
    reread = Wav2VecBert(infra={"folder": str(root / "cache")})  # no backbone: cannot compute
    cached = reread._get_data(events)
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(cached, got))
    log(f"Wav2VecBert (w2v-BERT 2.0, {len(events)} Sound events of {AUDIO_CHUNKS_S} s in one "
        f"48 kHz stereo wav): {seconds:.2f} s, shapes {[np.shape(g) for g in got]}; against "
        f"encode_sound_stream: max rel L2 {worst_rel:.3e} (tol {rel_tol:.0e}), min cosine "
        f"{worst_cos:.6f} (tol {cos_tol}); cached reread equal: {same}")
    if not (worst_rel <= rel_tol and worst_cos >= cos_tol and same):
        raise SystemExit("the Wav2VecBert feature disagrees with encode_sound_stream or its cache")


def trimodal_path(root: Path, llama: TorchTextBackbone, audio: TorchAudioBackbone) -> dict:
    """``grids/defaults.py`` whole on the card: the text (Llama-3.2-3B),
    audio (w2v-BERT 2.0) and video (ViT-G, static int8) features at full
    width, seeded, and the flagship trunk with InfoNCE on video, over a
    synthetic study with video.  The audio feature gets a fresh backbone
    over ``audio``'s model, with no graph captured yet: it captures its
    buckets' graphs while the other features work on the card in their
    threads (``prepare_features``)."""
    study = make_synthetic_study(root / "data", **TRIMODAL_STUDY)
    cfg = experiment_config(root, study, "trimodal_run", modalities=("text", "audio", "video"),
                            n_epochs=1)
    cfg["save_checkpoints"] = False
    vit_cfg = dataclasses.replace(VJEPA2_VITG, quantize=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    model = _calibrated_static_model(quantized_backbone(vit_cfg, gen), vit_cfg.frames_per_clip,
                                     vit_cfg.crop_size)
    video = TorchVideoBackbone(model, n_frames=vit_cfg.frames_per_clip, crop_size=vit_cfg.crop_size)
    exp = Experiment(**cfg)
    exp.data.text_feature.set_backbone(llama)
    audio = TorchAudioBackbone(audio.model)
    exp.data.audio_feature.set_backbone(audio)
    exp.data.video_feature.set_backbone(video)
    clock = StageClock()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, total_s = clock.run(exp)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # every video (two train, one test) is windowed at 2 Hz, in batches of 4;
    # the text kernel runs in the forwards of width 256
    windows = int(round(2 * TRIMODAL_STUDY["duration"]))
    batches = 3 * -(-windows // exp.data.video_feature.window_batch)
    expected = {"flash_attention": vit_cfg.num_layers * batches,
                "w8a8": 2 * vit_cfg.num_layers * batches, "w8a8_rope": 2 * vit_cfg.num_layers * batches,
                "int8_mlp": vit_cfg.num_layers * batches}
    log(f"Experiment (trimodal default: Llama-3.2-3B, w2v-BERT 2.0, ViT-G int8, flagship trunk): "
        f"{total_s:.2f} s; by stage { {k: round(v, 3) for k, v in clock.seconds.items()} }; "
        f"peak {peak_gb:.2f} GB; launches {launches} (video rows expected {expected}); "
        f"audio {audio.counts}; metrics {json.dumps(out)}")
    check_artifacts(Path(cfg["infra"]["folder"]), out, "Experiment (trimodal)", checkpoint=False)
    if {k: launches[k] for k in expected} != expected or not (
            launches["attention"] and launches["flash_masked"]):  # rows 1 and 2
        raise SystemExit("the trimodal Experiment did not launch the kernels as expected")
    # no hook on the backbone: each chunk is one graph, captured after the
    # chunk (its bucket's first, or its first since a larger bucket came)
    # beside the other features' threads, or replayed
    graphs = audio.counts["graph_captures"], audio.counts["graph_replays"]
    if not (min(graphs) >= 1 and sum(graphs) == audio.counts["chunks"]):
        raise SystemExit(f"the trimodal Experiment's audio gave {audio.counts}: not a capture or a replay a chunk")
    return {"seconds": clock.seconds, "total_s": total_s, "peak_gb": peak_gb, "launches": launches,
            "cfg": cfg}


# phase 10: the model soup through run_ensemble -> launch_sweep -> run_grid
# over phase 9's trimodal study and caches; a profiled Experiment over phase
# 9's text study; save_attn_out against phase 4's full remat; the optimizers,
# schedulers, losses and FmriMlp of this slice on the card against the CPU
SOUP_MIN_MEMBERS = 4
#: the soup's axes the members must cover between them, with the values required
SOUP_COVER = {
    "loss.name": {"SmoothL1Loss", "HuberLoss"},
    "data.layer_aggregation": {None, "group_mean"},
    "brain_model_config.layer_aggregation": {"cat", "mean"},
    "brain_model_config.feature_aggregation": {"cat", "sum"},
    "brain_model_config.subject_embedding": {True, False},
}
#: the GB a soup member may leave allocated on the card behind it
SOUP_LEFT_GB = 1.0
#: average_submissions' own settings (its __main__), and the limit of the
#: ensemble against its NumPy recomputation (relative to the largest value)
ENSEMBLE = dict(weigh_by_score=True, per_voxel_weights=True, temperature=0.3)
ENSEMBLE_RTOL = 1e-6
GRID_SEEDS = 5
#: rows 2, 4, 6, 7 and 8: the feature kernels, which a run over cached features never launches
FEATURE_KERNELS = ("flash_masked", "flash_attention", "w8a8", "w8a8_rope", "int8_mlp", "flash_relkey")
PROFILE_FIRST, PROFILE_LAST = 6, 4
#: the profiled run trains two epochs (the trace covers the first): does the
#: second start slow as well?
PROFILE_EPOCHS = 2
REMAT_STEPS = 3
REMAT_RTOL = 1e-5
NEW_OPTIMIZERS = ("SGD", "Adagrad", "RMSprop", "Lion", "Adamax", "NAdam", "RAdam", "Adadelta",
                  "Adafactor", "LAMB")
NEW_SCHEDULERS = {"CosineAnnealingLR": {"eta_min": 1e-6}, "StepLR": {"step_size": 1, "gamma": 0.5},
                  "LinearLR": {"start_factor": 0.5, "total_iters": 3}}
SOUP_LOSSES = ("SmoothL1Loss", "HuberLoss", "PearsonLoss", "MSELoss")
FMRI_MLP_CASES = (dict(hidden=1024, n_blocks=4, subject_layers=True, n_subjects=4),
                  dict(hidden=1024, n_blocks=2, use_tr_layer=True, use_tr_embeds=True,
                       n_repetition_times=4, time_agg="out_linear"))
FMRI_MLP_ATOL = 1e-5


def counted_features(computed: list):
    """Patches that record every event a feature computes (none may)."""
    def counted(compute):
        def wrapper(self, events):
            computed.extend(events)
            yield from compute(self, events)
        return wrapper
    return [mock.patch.object(cls, "_compute", counted(cls._compute))
            for cls in (LLAMA3p2, Wav2VecBert, VJEPA2)]


class MemberClock:
    """Per ``Experiment.run`` inside a job array: seconds, the peak, the
    memory allocated on the card before and after (after a collection),
    and the kernels launched."""

    def __init__(self):
        self.members: list[dict] = []

    def wrap(self, run):
        def wrapper(experiment):
            gc.collect()
            torch.cuda.synchronize()
            before, counts = torch.cuda.memory_allocated(), launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = run(experiment)
            torch.cuda.synchronize()
            seconds, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
            gc.collect()
            now = launch_counts()
            self.members.append({
                "seconds": seconds, "peak_gb": peak / 1e9,
                "before_gb": before / 1e9, "after_gb": torch.cuda.memory_allocated() / 1e9,
                "launches": {k: now[k] - counts[k] for k in now}, "out": out,
            })
            return out
        return wrapper


def soup_update(trimodal_cfg: dict) -> dict:
    """Overrides of the default config: phase 9's trimodal study and caches,
    the card, one epoch, the metrics stream to local JSONL only (offline
    wandb; the sweep names each run in ``wandb_config``)."""
    cfg = ConfDict(trimodal_cfg)
    keys = ["data.study.path", "data.study.infra.folder", "data.neuro.infra.folder",
            *(f"data.{feature}.infra.folder" for feature in FEATURES)]
    return {**{key: cfg[key] for key in keys}, "accelerator": "cuda", "n_epochs": 1,
            "wandb_config.offline": True}


def soup_axes(config) -> str:
    return ", ".join(f"{key.removeprefix('brain_model_config.')}={config[key]}"
                     for key in SOUP_COVER)


def recompute_ensemble(grid: Path) -> dict:
    """The score-weighted per-voxel ensemble in NumPy float64 from the
    members' submission zips and pearson.npy: softmax over members of
    pearson / temperature at each voxel, weighted sum of predictions."""
    folders = sorted(path.parent for path in grid.glob("*/submission.zip"))
    preds, pearson = [], []
    for folder in folders:
        with zipfile.ZipFile(folder / "submission.zip") as zf:
            preds.append(np.load(io.BytesIO(zf.read(zf.namelist()[0])), allow_pickle=True).item())
        pearson.append(np.load(folder / "pearson.npy").astype(np.float64))
    logits = np.stack(pearson) / ENSEMBLE["temperature"]
    weights = np.exp(logits - logits.max(axis=0))
    weights /= weights.sum(axis=0)
    return {subject: {chunk: np.einsum("rv,rtv->tv", weights, np.stack(
                [np.asarray(p[subject][chunk], np.float64) for p in preds]))
                      for chunk in chunks}
            for subject, chunks in preds[0].items()}


def soup_path(root: Path, trimodal_cfg: dict) -> dict:
    """The ensemble as users run it: ``grids/run_ensemble.py`` samples the
    soup, ``_launch.launch_sweep`` expands it over the default config and
    ``experiment/grid.run_grid`` runs the members one after another in this
    process, at full width over phase 9's trimodal features (no feature
    computed); ``average_submissions`` combines them."""
    savedir, update = root / "soup", soup_update(trimodal_cfg)
    for seed in range(1000):  # the first sample seed whose draws cover SOUP_COVER
        planned = run_ensemble.main(["--dry-run", "--n-models", str(SOUP_MIN_MEMBERS),
                                     "--sample-seed", str(seed), "--savedir", str(savedir)],
                                    base_update=update)
        if all({c[key] for c in planned} >= values for key, values in SOUP_COVER.items()):
            break
    else:
        raise SystemExit(f"no sample seed below 1000 covers {SOUP_COVER} with "
                         f"{SOUP_MIN_MEMBERS} members")
    grid = run_grid_cli.main(["--dry-run", "--seeds", str(GRID_SEEDS), "--savedir", str(savedir)],
                             base_update=update)
    log(f"soup: --sample-seed {seed}, {len(planned)} members: "
        f"{[soup_axes(c) for c in planned]}; run_grid --dry-run: {len(grid)} configs "
        f"({len(run_grid_cli.LAYER_CHOICES)} layer choices x {GRID_SEEDS} seeds)")
    if len(grid) != len(run_grid_cli.LAYER_CHOICES) * GRID_SEEDS:
        raise SystemExit("run_grid --dry-run did not enumerate the layer x seed grid")
    clock, computed = MemberClock(), []
    patches = [mock.patch.object(Experiment, "run", clock.wrap(Experiment.run)),
               *counted_features(computed)]
    for patch in patches:
        patch.start()
    reset_counts()
    t0 = time.perf_counter()
    try:
        configs = run_ensemble.main(
            ["--n-models", str(SOUP_MIN_MEMBERS), "--sample-seed", str(seed), "--savedir",
             str(savedir), "--non-interactive"], base_update=update)
    finally:
        for patch in patches:
            patch.stop()
    soup_s = time.perf_counter() - t0
    for member, config in zip(clock.members, configs):
        log(f"soup member ({soup_axes(config)}, dropout "
            f"{config['brain_model_config.modality_dropout']}, layers {config['data.layers']}): "
            f"{member['seconds']:.2f} s, peak {member['peak_gb']:.2f} GB, allocated "
            f"{member['before_gb']:.3f} -> {member['after_gb']:.3f} GB, launches "
            f"{ {k: v for k, v in member['launches'].items() if v} }, val/pearson "
            f"{member['out'].get('val/pearson')}")
    t0 = time.perf_counter()
    zip_path = average_submissions.average_submissions(savedir / run_ensemble.SWEEP, **ENSEMBLE)
    average_s = time.perf_counter() - t0
    got = np.load(zip_path.with_suffix(".npy"), allow_pickle=True).item()
    want = recompute_ensemble(savedir / run_ensemble.SWEEP)
    rel = max(np.abs(got[s][c] - w).max() / np.abs(w).max()
              for s, chunks in want.items() for c, w in chunks.items())
    log(f"soup: {len(clock.members)} members in {soup_s:.2f} s, {len(computed)} feature events "
        f"computed; average_submissions {ENSEMBLE} in {average_s:.3f} s: {zip_path.name}, "
        f"{sum(len(c) for c in got.values())} chunks, against its NumPy recomputation max "
        f"rel {rel:.3e} (tol {ENSEMBLE_RTOL:.0e})")
    if len(clock.members) != len(configs) or len(configs) < SOUP_MIN_MEMBERS or computed:
        raise SystemExit("the soup did not run its members over the cached features")
    for member in clock.members:
        launches = member["launches"]
        if not launches["attention"] or any(launches[k] for k in FEATURE_KERNELS):
            raise SystemExit(f"a soup member launched {launches}: row 1 in every member, "
                             f"{FEATURE_KERNELS} never")
        if abs(member["after_gb"] - member["before_gb"]) > SOUP_LEFT_GB:
            raise SystemExit("a soup member left its device memory allocated")
        if not np.isfinite(member["out"]["val/pearson"]):
            raise SystemExit("a soup member gave a non-finite val/pearson")
    if set(got) != set(want) or not rel <= ENSEMBLE_RTOL:
        raise SystemExit("the ensemble submission disagrees with its NumPy recomputation")
    return {"members": clock.members, "seed": seed, "seconds": soup_s,
            "attention": sum(m["launches"]["attention"] for m in clock.members)}


class LoaderClock:
    """Host intervals (one clock) of the train steps, unsynchronised as the
    Experiment runs them, and of the loader's item assembly on its threads
    (``SegmentDataset.__getitem__``): how much loader work each step
    overlaps."""

    def __init__(self):
        self.steps: list[tuple[int, float, float]] = []
        self.items: list[tuple[float, float]] = []

    def step(self, fn):
        def wrapper(trainer, data, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(trainer, data, *args, **kwargs)
            self.steps.append((len(trainer.history), t0, time.perf_counter()))
            return out
        return wrapper

    def item(self, fn):
        def wrapper(dataset, idx):
            t0 = time.perf_counter()
            out = fn(dataset, idx)
            self.items.append((t0, time.perf_counter()))
            return out
        return wrapper

    def per_step(self) -> list[dict]:
        """Per train step: its epoch, host seconds, and the loader's
        item-seconds (summed over threads) and items inside its window."""
        out = []
        for epoch, t0, t1 in self.steps:
            inside = [(max(s, t0), min(e, t1)) for s, e in self.items if s < t1 and e > t0]
            out.append({"epoch": epoch, "host_s": t1 - t0, "items": len(inside),
                        "loader_s": sum(e - s for s, e in inside)})
        return out


def profiled_experiment(root: Path, study: Path) -> dict:
    """``Experiment(profile=True)`` over phase 9's text study and feature
    cache, in a fresh run folder, no checkpoint: the trace of its first
    epoch, read back step by step; and, for both of its two epochs, the
    loader's item assembly inside each step."""
    cfg = experiment_config(root, study, "profile_run", n_epochs=PROFILE_EPOCHS)
    cfg.update(profile=True, save_checkpoints=False)
    computed, loader = [], LoaderClock()
    patches = [*counted_features(computed),
               mock.patch.object(BrainTrainer, "train_step", loader.step(BrainTrainer.train_step)),
               mock.patch.object(SegmentDataset, "__getitem__",
                                 loader.item(SegmentDataset.__getitem__))]
    for patch in patches:
        patch.start()
    reset_counts()
    log(f"profiled Experiment: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved by the caching allocator before it")
    t0 = time.perf_counter()
    try:
        out = Experiment(**cfg).run()
        torch.cuda.synchronize()
    finally:
        for patch in patches:
            patch.stop()
    total_s, launches = time.perf_counter() - t0, launch_counts()
    trace = Path(cfg["infra"]["folder"]) / "profile" / "trace.json"
    if not trace.is_file():
        raise SystemExit(f"Experiment(profile=True) wrote no trace at {trace}")
    t0 = time.perf_counter()
    steps = step_summary(trace)
    read_s = time.perf_counter() - t0
    log(f"profiled Experiment (text, flagship trunk, {PROFILE_EPOCHS} epochs, the first traced): "
        f"{total_s:.2f} s, trace "
        f"{trace.stat().st_size / 1e6:.1f} MB read in {read_s:.2f} s, {len(computed)} words "
        f"computed, launches {launches}; metrics {json.dumps(out)}")
    for step in steps:
        calls = sorted(step["runtime_ms"].items(), key=lambda kv: -kv[1])[:4]
        log(f"  step {step['step']}: host {step['host_ms']:.2f} ms (waited {step['wait_ms']:.2f} ms "
            f"before), device busy {step['device_ms']:.2f} ms, {step['launches']} launches; "
            f"runtime calls {[(name, round(ms, 2)) for name, ms in calls]}")

    def mean(part, key):
        return statistics.mean(s[key] for s in part)

    first, last = steps[:PROFILE_FIRST], steps[-PROFILE_LAST:]
    for label, part in ((f"first {PROFILE_FIRST}", first), (f"last {PROFILE_LAST}", last)):
        log(f"  {label} steps: host {mean(part, 'host_ms'):.2f} ms, device busy "
            f"{mean(part, 'device_ms'):.2f} ms, launches {mean(part, 'launches'):.1f}, wait "
            f"{mean(part, 'wait_ms'):.2f} ms")
    overlap = loader.per_step()
    log("  loader inside each train step (epoch, host s, item-seconds on its threads, items): "
        f"{[(o['epoch'], round(o['host_s'], 3), round(o['loader_s'], 3), o['items']) for o in overlap]}")
    if len(steps) < PROFILE_FIRST + PROFILE_LAST or computed or launches["flash_masked"]:
        raise SystemExit(f"the profiled Experiment traced {len(steps)} steps or computed features")
    if not all(s["device_ms"] > 0 and s["launches"] > 0 for s in steps) or not launches["attention"]:
        raise SystemExit("the trace holds a train step with no work on the card")
    if len({o["epoch"] for o in overlap}) != PROFILE_EPOCHS:
        raise SystemExit("the profiled Experiment did not train its epochs")
    return {"steps": steps, "total_s": total_s, "first": first, "last": last,
            "loader": overlap}


def remat_path(full: dict) -> dict:
    """Phase 4's flagship trainer with ``remat_policy="save_attn_out"``: the
    same seed and the first batches of phase 4 give the same losses as its
    full remat."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    train = [make_batch(FLAGSHIP_DIMS, 1000, 16, 298, gen) for _ in range(REMAT_STEPS)]
    trainer = make_trainer(FLAGSHIP_DIMS, 1000, metrics=METRICS, remat_policy="save_attn_out")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.init_state(train[0], total_steps=100)
    losses, step_s = [], []
    for batch in train:
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch.data)[0].item())
        step_s.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()["attention"]
    trainer.release()
    want = full["losses"][:REMAT_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    depth = trainer.model.config.depth
    log(f"save_attn_out, {REMAT_STEPS} flagship steps: losses {losses} against full remat's "
        f"{want}, max rel {rel:.3e} (tol {REMAT_RTOL:.0e}); peak {peak_gb:.2f} GB against "
        f"{full['train_peak_gb']:.2f} GB; step {statistics.median(step_s[1:]):.4f} s against "
        f"{full['step_s']:.4f} s; row-1 launches a step {launches / REMAT_STEPS:.1f} against "
        f"full remat's {2 * depth}")
    if not rel <= REMAT_RTOL or launches != 2 * depth * REMAT_STEPS:
        raise SystemExit("save_attn_out disagrees with full remat")
    return {"peak_gb": peak_gb, "step_s": statistics.median(step_s[1:]), "losses": losses}


def check_optimizers_against_cpu() -> None:
    """The small trunk trained 3 steps on the card and on the CPU from the
    same weights with each optimizer of this slice (each scheduler and each
    soup loss in turn): the losses agree to 1e-4 (phase 3's limit)."""
    dims = {"text": (2, 40), "audio": (2, 16), "video": (2, 24)}
    small = dict(hidden=96, depth=2, heads=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batches = [make_batch(dims, 20, 4, 200, gen) for _ in range(3)]
    worst = {}
    for name, (scheduler, kwargs), loss in zip(NEW_OPTIMIZERS, itertools.cycle(NEW_SCHEDULERS.items()),
                                               itertools.cycle(SOUP_LOSSES)):
        optim = {"optimizer": {"name": name, "lr": 1e-3},
                 "scheduler": {"name": scheduler, "kwargs": kwargs}}
        gpu = make_trainer(dims, 20, optim=optim, loss=loss, **small)
        cpu = make_trainer(dims, 20, device="cpu", optim=optim, loss=loss, **small)
        gpu.init_state(batches[0], total_steps=3)
        cpu.init_state(batches[0], total_steps=3)
        cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
        rel = 0.0
        for batch in batches:
            lg = gpu.train_step(batch.data)[0].item()
            lc = cpu.train_step({k: v.cpu() for k, v in batch.data.items()})[0].item()
            rel = max(rel, abs(lg - lc) / abs(lc))
        worst[f"{name}/{scheduler}/{loss}"] = rel
    log(f"small trunk, 3 steps, card vs CPU per optimizer / scheduler / loss: max rel loss diff "
        f"{ {k: f'{v:.2e}' for k, v in worst.items()} } (tol 1e-4)")
    if not all(v <= 1e-4 for v in worst.values()):
        raise SystemExit("an optimizer on the card disagrees with the CPU")


def check_fmri_mlp_against_cpu() -> None:
    """FmriMlp on the card and on the CPU from the same weights."""
    errs = []
    for i, kw in enumerate(FMRI_MLP_CASES):
        cfg = FmriMlpConfig(**kw)
        cpu = cfg.build(n_in_channels=2 * 1408, n_outputs=1000)
        cpu.init_weights(torch.Generator().manual_seed(SEED + i))
        gpu = cfg.build(n_in_channels=2 * 1408, n_outputs=1000, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        x = torch.randn((8, 2, 1408, kw.get("n_repetition_times", 1)),
                        generator=torch.Generator().manual_seed(SEED))
        subjects = torch.arange(8) % 4
        with torch.no_grad():
            want = cpu(x, subjects)
            got = gpu(x.cuda(), subjects.cuda()).cpu()
        errs.append(float((got - want).abs().max()))
    log(f"FmriMlp {len(FMRI_MLP_CASES)} configs, card vs CPU: max abs diff {errs} "
        f"(tol {FMRI_MLP_ATOL:.0e})")
    if not all(e <= FMRI_MLP_ATOL for e in errs):
        raise SystemExit("FmriMlp on the card disagrees with the CPU")


# phase 11: the parallel strategies on the one card.  (a)'s limit on the
# losses of phase 4's seed and batches through a ("data", "model") mesh of
# one device: nothing is split, so they must be phase 4's (relative; the
# first reading on an H100 was 0, bit-equal); (b)'s two ranks on cuda:0
# (and --cards' N ranks, one a card) split the batch (dp) or the weights
# (tp) and sum in another order: their losses within this limit of one
# device's, ~10x the first readings (dp2 0, bit-equal; tp2, dp4 and dp2 x
# tp2 over 4 cards 1.1e-7)
PARALLEL_STEPS = 3
DP1_RTOL = 1e-6
TWO_RANK_RTOL = 1e-6
#: (b) and --cards: Adafactor and LAMB, which reduce over whole parameters,
#: in the dp x tp2 world after phase 4's optimizer, 2 steps each against
#: one process of the same optimizer, within TWO_RANK_RTOL (first readings
#: on an H100: 0, bit-equal); a constant LR, so that the second step's
#: loss moves with the first update
TP_OPTIMIZERS = {name: {"optimizer": {"name": name, "lr": 1e-2}} for name in ("Adafactor", "LAMB")}
TP_OPTIM_STEPS = 2
#: (c) and (d): shards and stages, all on cuda:0
SP_SHARDS = 8
PP_STAGES = 4
PP_MICROBATCHES = 2
#: (c)'s limits of the ring's token-pooled features against phase 5's
#: through row 4 (min cosine, max relative L2 a window and layer): phase
#: 5's limits of kernels vs plain, where fp32 ring vs bf16 flash may move
#: int8 rounding ties (ROADMAP section 3); first reading on an H100:
#: 0.9999944, 3.3e-3 at layer 40 (phase 5's kernels vs plain: 3.4e-3)
SP_LIMITS = (0.9999, 1e-2)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_trainer_steps(mesh, n_steps: int = PARALLEL_STEPS, **trainer_kw) -> dict:
    """Phase 4's flagship trainer over ``mesh``, from phase 4's seed and its
    first ``n_steps`` batches: the losses, the median step, the peak."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    train = [make_batch(FLAGSHIP_DIMS, 1000, 16, 298, gen) for _ in range(n_steps)]
    trainer = make_trainer(FLAGSHIP_DIMS, 1000, mesh=mesh, **trainer_kw)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.init_state(train[0], total_steps=100)
    losses, step_s = [], []
    for batch in train:
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch.data)[0].item())
        step_s.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in trainer.model.parameters())
    trainer.release()
    return {"losses": losses, "step_s": statistics.median(step_s[1:]), "peak_gb": peak_gb,
            "n_params": n_params}


def dp_world1_path(run: dict) -> dict:
    """(a) ``init_distributed`` over NCCL with a localhost rendezvous, a
    mesh of the one device, and phase 4's trainer on it."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    t0 = time.perf_counter()
    init_distributed()
    try:
        mesh = get_mesh(n_devices=1)
        if dist.get_backend() != "nccl":
            raise SystemExit(f"init_distributed took {dist.get_backend()}, not NCCL, on the card")
        reset_counts()
        out = parallel_trainer_steps(mesh)
        launches = launch_counts()["attention"]
    finally:
        dist.destroy_process_group()
        for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            os.environ.pop(key)
    want = run["losses"][:PARALLEL_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], want))
    depth = FmriEncoderConfig().depth
    log(f"(a) dp over NCCL, world 1 ({mesh}): losses {out['losses']} against phase 4's {want}, "
        f"max rel {rel:.3e} (tol {DP1_RTOL:.0e}); median step {out['step_s']:.4f} s (phase 4: "
        f"{run['step_s']:.4f} s); peak {out['peak_gb']:.2f} GB (phase 4's train peak "
        f"{run['train_peak_gb']:.2f} GB); row-1 launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not rel <= DP1_RTOL or launches != 2 * depth * PARALLEL_STEPS:
        raise SystemExit("the flagship trainer over a one-device mesh disagrees with phase 4")
    return {**out, "seconds": time.perf_counter() - t0}


def rank_worker(rank: int, world: int, port: int, model_parallel: int, cards: bool,
                optimizers: tuple, results) -> None:
    """One rank of (b) or of ``--cards``: on its own card over NCCL, joined
    from torchrun's environment variables by ``init_distributed``
    (``cards``), or on cuda:0 over gloo with CUDA tensors.  Phase 4's
    trainer for each of ``optimizers`` (None: phase 4's; a name of
    ``TP_OPTIMIZERS``: that one, ``TP_OPTIM_STEPS`` steps) in turn."""
    try:
        if cards:
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                              WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
            init_distributed()
        else:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                    world_size=world)
        try:
            outs = []
            for name in optimizers:
                reset_counts()
                kw = {} if name is None else {"n_steps": TP_OPTIM_STEPS,
                                              "optim": TP_OPTIMIZERS[name]}
                out = parallel_trainer_steps(get_mesh(world, model_parallel), **kw)
                outs.append({**out, "attention": launch_counts()["attention"],
                             "device": torch.cuda.current_device()})
            results.put((rank, outs))
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException as err:  # the parent fails the phase with it
        results.put((rank, f"{type(err).__name__}: {err}"))
        raise


def ranks_path(ref: dict, world: int, cards: bool, part: str, tp_refs: dict) -> dict:
    """Phase 4's trainer in ``world`` processes: data parallelism over all
    of them (dp{world}) and dp{world/2} x tp2, the losses held to ``ref``'s;
    the dp{world/2} x tp2 world then runs Adafactor and LAMB, each held to
    ``tp_refs[name]``, one process's run of that optimizer.  (b):
    two ranks on the one card over gloo, which takes CUDA tensors for the
    all-reduce, all-gather and broadcast of DP and TP (checked on an H100:
    PERF.md); ``--cards``: one rank a card over NCCL."""
    import multiprocessing
    import queue

    # hand the parent's cached blocks back, for the ranks' trainers
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    ctx = multiprocessing.get_context("spawn")
    where = "one a card over NCCL" if cards else "on cuda:0 over gloo"
    tp = f"dp{world // 2} x tp2"
    for label, model_parallel, optimizers in ((f"dp{world}", 1, (None,)),
                                              (tp, 2, (None, *TP_OPTIMIZERS))):
        t0 = time.perf_counter()
        results = ctx.Queue()
        port = free_port()
        procs = [ctx.Process(target=rank_worker,
                             args=(rank, world, port, model_parallel, cards, optimizers, results))
                 for rank in range(world)]
        got = {}
        try:
            for proc in procs:
                proc.start()
            while len(got) < world:
                try:
                    rank, value = results.get(timeout=600)
                except queue.Empty:
                    raise SystemExit(f"{part} {label}: a rank gave no result in 600 s") from None
                if isinstance(value, str):
                    raise SystemExit(f"{part} {label}: rank {rank} failed: {value}")
                got[rank] = value
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        seconds = time.perf_counter() - t0
        depth = FmriEncoderConfig().depth
        for i, name in enumerate(optimizers):
            ranks = [got[r][i] for r in range(world)]
            want, what, steps = ((ref["losses"], ref["what"], PARALLEL_STEPS) if name is None
                                 else (tp_refs[name]["losses"], f"one process's {name}",
                                       TP_OPTIM_STEPS))
            rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], want))
            run = label if name is None else f"{tp} {name}"
            log(f"{part} {run}, {world} ranks {where}: losses {[r['losses'] for r in ranks]} "
                f"against {what} {want}, max rel {rel:.3e} (tol {TWO_RANK_RTOL:.0e}); median "
                f"step {[round(r['step_s'], 4) for r in ranks]} s; peaks "
                f"{[round(r['peak_gb'], 2) for r in ranks]} GB; params a rank "
                f"{ranks[0]['n_params']}; cards {[r['device'] for r in ranks]}; row-1 launches "
                f"{[r['attention'] for r in ranks]}")
            if not rel <= TWO_RANK_RTOL or any(r["attention"] != 2 * depth * steps for r in ranks):
                raise SystemExit(f"{part} {run} disagrees with one device")
            out[run] = {"rel": rel, "step_s": statistics.median(r["step_s"] for r in ranks)}
        out[label]["seconds"] = seconds
    return out


def tp_optimizer_refs() -> dict:
    """One process's run of phase 4's trainer with each of TP_OPTIMIZERS on
    the card: what (b) and --cards hold tensor parallelism to."""
    refs = {}
    for name, optim in TP_OPTIMIZERS.items():
        refs[name] = parallel_trainer_steps(None, n_steps=TP_OPTIM_STEPS, optim=optim)
        log(f"one process, {name}: losses {refs[name]['losses']}, median step "
            f"{refs[name]['step_s']:.4f} s, peak {refs[name]['peak_gb']:.2f} GB")
    return refs


@torch.no_grad()
def sequence_parallel_path(video: dict | None, mesh, part: str = "(c)") -> dict:
    """(c) Phase 5's ViT-G (the same seed and calibration) with its 8192
    tokens a window split over the shards of ``mesh`` (ring attention,
    sequence_parallel_axis), on phase 5's first window batch, against
    phase 5's features (``video``, or, without phase 5, the same model and
    windows through row 4 on cuda:0)."""
    cfg = dataclasses.replace(VJEPA2_VITG, quantize=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    t0 = time.perf_counter()
    model = _calibrated_static_model(quantized_backbone(cfg, gen), cfg.frames_per_clip,
                                     cfg.crop_size)
    if video is None:
        rng = np.random.default_rng(SEED + 6)
        windows = [rng.integers(0, 256, (cfg.frames_per_clip, 288, 512, 3), dtype=np.uint8)
                   for _ in range(4)]
        one = TorchVideoBackbone(model, n_frames=cfg.frames_per_clip, crop_size=cfg.crop_size)
        t1 = time.perf_counter()
        first = one.encode_windows(np.stack(windows)).astype(np.float64)
        video = {"windows": windows, "window_batch": 4, "first_batch": first,
                 "batch_s": time.perf_counter() - t1, "what": "one card, a first call"}
    backbone = TorchVideoBackbone(model, n_frames=cfg.frames_per_clip, crop_size=cfg.crop_size,
                                  mesh=mesh, sequence_parallel=True)
    batch = np.stack(video["windows"][: video["window_batch"]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    got = backbone.encode_windows(batch).astype(np.float64)  # (B, L+1, D)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t1
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ref = video["first_batch"].astype(np.float64)
    norms = np.linalg.norm(ref, axis=-1)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * norms)
    rel = np.linalg.norm(got - ref, axis=-1) / norms
    per_shard = cfg.num_layers * mesh.size
    expected = {**{key: 0 for key in launches}, "w8a8": 2 * per_shard, "w8a8_rope": 2 * per_shard,
                "int8_mlp": per_shard}
    log(f"{part} ViT-G over {mesh.size} shards on {sorted({str(d) for d in mesh.devices})} "
        f"({batch.shape[0]} windows, 8192 tokens each, {8192 // mesh.size} a shard): "
        f"{batch_s:.3f} s ({video.get('what', 'phase 5')}: {video['batch_s']:.4f} s a batch), peak "
        f"{peak_gb:.2f} GB on cuda:0; against phase 5's features through row 4: min cosine "
        f"{cos.min():.7f} (tol {SP_LIMITS[0]}), max rel L2 {rel.max():.3e} (tol "
        f"{SP_LIMITS[1]:.0e}) at layer {int(rel.max(axis=0).argmax())}; launches {launches} "
        f"(expected {expected}); {time.perf_counter() - t0:.1f} s")
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise SystemExit(f"{part} features {got.shape} (want {ref.shape}) or non-finite values")
    if launches != expected:
        raise SystemExit(f"{part} the sequence-parallel path did not launch the kernels as reckoned")
    if not (cos.min() >= SP_LIMITS[0] and rel.max() <= SP_LIMITS[1]):
        raise SystemExit(f"{part} the ring's features disagree with phase 5's")
    return {"batch_s": batch_s, "peak_gb": peak_gb, "seconds": time.perf_counter() - t0}


@torch.no_grad()
def pipeline_path(mesh, part: str = "(d)") -> dict:
    """(d) Phase 6's Llama-3.2-3B (the same seed) with its 28 layers in the
    stages of ``mesh`` (each stage's layers on its device, as
    ``TorchTextBackbone(pipeline_mesh=)`` places them), one of phase 6's
    (8, 1024) batches in PP_MICROBATCHES microbatches through
    ``pipelined_llama_states``, held to the scanned forward on cuda:0 by
    phase 6's measure."""
    cfg = LLAMA_3P2_3B
    gc.collect()
    t0 = time.perf_counter()

    def seeded():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        return LlamaBackbone(cfg, device="cuda").init_random(gen)

    model = seeded()
    backbone = TorchTextBackbone(model, HashTokenizer(cfg.vocab_size), pad_id=0,
                                 pipeline_mesh=mesh)
    # the scanned forward needs every layer on cuda:0: over real cards, a
    # second copy of the same seeded weights
    scanned = model if set(mesh.devices) == {model.embed_tokens.weight.device} else seeded()
    batch = transcript(1280, 1024, SEED + 11)[1024 : 1024 + 8]
    ids, mask = backbone.encode_pretokenized(backbone.chain_tokenize([c for _, c in batch]), 1024)
    ids_t = torch.from_numpy(ids).to("cuda", torch.long)
    mask_t = torch.from_numpy(mask).to("cuda", torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    got = pipelined_llama_states(cfg, model, ids_t, mask_t, mesh, n_microbatches=PP_MICROBATCHES)
    torch.cuda.synchronize()
    pp_ms = (time.perf_counter() - t1) * 1e3
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = scanned(ids_t, mask_t)
    # phase 6's measure on pooled word vectors: each row's last len(word) tokens
    spans = torch.tensor([max(1, min(len(w), int(n))) for (w, _), n in zip(batch, mask.sum(-1))],
                         device="cuda")
    n_valid = mask_t.sum(-1)
    pos = torch.arange(ids.shape[1], device="cuda")[None]
    sel = (pos >= (n_valid - spans)[:, None]) & (pos < n_valid[:, None])
    weights = (sel / sel.sum(-1, keepdim=True)).float()

    def pooled(states):
        return torch.einsum("lbtd,bt->bld", states, weights).cpu().numpy()

    expected = {**{key: 0 for key in launches}, "flash_masked": cfg.num_layers * PP_MICROBATCHES}
    log(f"{part} Llama-3.2-3B in {mesh.size} stages on "
        f"{[str(d) for d in mesh.devices]}, {PP_MICROBATCHES} microbatches of "
        f"{ids.shape[0] // PP_MICROBATCHES}: {pp_ms:.2f} ms (phase 6: an (8, 1024) forward), "
        f"peak {peak_gb:.2f} GB on cuda:0; states {tuple(got.shape)}; launches {launches} "
        f"(expected {expected})")
    if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
        raise SystemExit(f"{part} states {tuple(got.shape)} or non-finite values")
    if launches != expected:
        raise SystemExit(f"{part} the pipelined Llama did not launch row 2 as reckoned")
    if not compare_pooled(pooled(got), pooled(want), f"{part}, (8, 1024)", cfg.dtype,
                          pair="pipelined vs scanned"):
        raise SystemExit(f"{part} the pipelined Llama disagrees with the scanned forward")
    return {"ms": pp_ms, "peak_gb": peak_gb, "seconds": time.perf_counter() - t0}


def parallel_path(run: dict, video: dict, name_and_limit: str) -> None:
    """Phase 11: (a) data parallelism over NCCL at world 1, (b) two ranks
    on the card over gloo, (c) sequence parallelism and (d) pipeline
    parallelism.  The card is one H100, so (c) and (d) call the backbone
    API over a LocalMesh of virtual shards and stages of cuda:0: the
    features' options (``VJEPA2(sequence_parallel=)``,
    ``LLAMA3p2(pipeline_stages=)``) ask for that many cards and raise."""
    t11 = time.perf_counter()
    dp1 = dp_world1_path(run)
    log(f"(a) {dp1['seconds']:.1f} s, peak {dp1['peak_gb']:.2f} GB on {name_and_limit}")
    two = ranks_path({**dp1, "what": "(a)'s"}, 2, cards=False, part="(b)",
                     tp_refs=tp_optimizer_refs())
    log(f"(b) dp2 {two['dp2']['seconds']:.1f} s, dp1 x tp2 (Adam, Adafactor, LAMB) "
        f"{two['dp1 x tp2']['seconds']:.1f} s on {name_and_limit}")
    sp = sequence_parallel_path(video, local_mesh(SP_SHARDS, "seq", "cuda:0"))
    log(f"(c) {sp['seconds']:.1f} s, peak {sp['peak_gb']:.2f} GB on {name_and_limit}")
    pp = pipeline_path(local_mesh(PP_STAGES, "stage", "cuda:0"))
    log(f"(d) {pp['seconds']:.1f} s, peak {pp['peak_gb']:.2f} GB on {name_and_limit}")
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")


def cards_path(n: int, name_and_limit: str) -> None:
    """``--cards N``: phase 11 over N cards of one host instead of one:
    phase 4's trainer as dpN and dp(N/2) x tp2 (Adam, then Adafactor and
    LAMB) in N processes over NCCL (one a card, joined through
    ``init_distributed``), held to its one-card losses; phase 5's ViT-G
    ring over N cards (a copy of the
    weights on each) and phase 6's Llama in N stages, one a card, each
    held to one card as (c) and (d) are.  N divides the ViT-G's 32
    tubelets and the Llama's 28 layers (2 or 4)."""
    t0 = time.perf_counter()
    ref = parallel_trainer_steps(None)
    log(f"one card: losses {ref['losses']}, median step {ref['step_s']:.4f} s, peak "
        f"{ref['peak_gb']:.2f} GB")
    ranks = ranks_path({**ref, "what": "one card's"}, n, cards=True, part=f"({n} cards)",
                       tp_refs=tp_optimizer_refs())
    log(f"({n} cards) " + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in ranks.items()
                                    if "seconds" in v) + f" (the tp world with Adam, Adafactor, "
        f"LAMB) on {name_and_limit}")
    sp = sequence_parallel_path(None, local_mesh(n, "seq"), part=f"({n} cards)")
    log(f"({n} cards) ring {sp['seconds']:.1f} s on {name_and_limit}")
    pp = pipeline_path(local_mesh(n, "stage"), part=f"({n} cards)")
    log(f"({n} cards) pipeline {pp['seconds']:.1f} s on {name_and_limit}")
    log(f"chip_smoke --cards {n}: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    started = time.perf_counter()
    name_and_limit = card()
    kind = torch.cuda.get_device_name(0)
    if sys.argv[1:2] == ["--cards"]:
        n = int(sys.argv[2])
        if torch.cuda.device_count() < n:
            raise SystemExit(f"--cards {n}: {torch.cuda.device_count()} cards are visible")
        _cuda.build_all()
        cards_path(n, name_and_limit)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
        }}), flush=True)
        return
    peaks = peaks_for(kind)
    torch.manual_seed(SEED)
    mutants = build_kernels()
    check_sass(_cuda.build("flash_attention"), {name: _cuda.build(name) for name in quant.INT8_EPILOGUES})
    check_tc_sass_unchanged(_cuda.build("flash_attention"))
    kernels = [check_attention(peaks), check_flash(peaks),
               check_flash_masked(peaks, {name: mutants[name] for name in MUTANTS}), check_fast(peaks),
               check_packed(peaks), check_relkey(peaks, {name: mutants[name] for name in RELKEY_MUTANTS}),
               check_w8a8(peaks), check_int8_mlp(peaks)]
    check_small_against_cpu()
    check_small_backbone_against_cpu()
    check_small_llama_against_cpu()
    check_small_audio_against_cpu()
    check_prefetch()
    run = main_path()
    log(f"trunk path: median step {run['step_s']:.4f} s, peak {run['peak_gb']:.2f} GB, "
        f"{run['n_params']} params on {name_and_limit}")
    video = video_path()
    log(f"video path: {video['batch_s']:.4f} s per window batch of 4 (first excluded), "
        f"peak {video['peak_gb']:.2f} GB on {name_and_limit}")
    text = text_path()
    log(f"text path: {text['batch_ms']:.2f} ms per (8, 1024) batch forward (first excluded), "
        f"{text['word_ms']:.3f} ms per word, peak {text['peak_gb']:.2f} GB on {name_and_limit}")
    bench = bench_path()
    log(f"attention bench: {bench['ms']} ms per call on {name_and_limit}")
    audio = audio_path(peaks)
    log(f"audio path: {audio['ms_chunk']:.2f} ms per 30-60 s chunk that opens a bucket (first excluded), "
        f"{audio['replay_ms']:.2f} ms the 60 s chunk replayed, "
        f"{audio['per_hour']:.3f} s per hour of audio, peak {audio['peak_gb']:.2f} GB, "
        f"{audio['n_params']} params on {name_and_limit}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        llama = seeded_llama()
        experiment = experiment_path(root / "text", llama, run["step_s"])
        log(f"Experiment: {experiment['total_s']:.2f} s, median step inside "
            f"{experiment['step_s']:.4f} s over {experiment['n_steps']} steps (min, max "
            f"{experiment['step_range'][0]:.4f}, {experiment['step_range'][1]:.4f} s; phase 4: "
            f"{run['step_s']:.4f} s; idle on data {experiment['idle']:.3f}), peak "
            f"{experiment['peak_gb']:.2f} GB, attention launches "
            f"{experiment['launches']['attention']}, flash_masked launches "
            f"{experiment['launches']['flash_masked']} on {name_and_limit}")
        check_small_experiment_against_cpu(root / "small")
        audio_feature_path(root / "audio", audio["backbone"])
        trimodal = trimodal_path(root / "trimodal", llama, audio["backbone"])
        log(f"trimodal Experiment: {trimodal['total_s']:.2f} s, peak {trimodal['peak_gb']:.2f} GB "
            f"on {name_and_limit}")
        del llama
        t10 = time.perf_counter()
        soup = soup_path(root / "phase10", trimodal["cfg"])
        log(f"soup: {len(soup['members'])} members (--sample-seed {soup['seed']}) in "
            f"{soup['seconds']:.2f} s, peaks {[round(m['peak_gb'], 2) for m in soup['members']]} GB "
            f"on {name_and_limit}")
        profiled = profiled_experiment(root / "text", experiment["study"])
        log(f"profiled Experiment: {profiled['total_s']:.2f} s; first {PROFILE_FIRST} / last "
            f"{PROFILE_LAST} steps: host "
            f"{statistics.mean(s['host_ms'] for s in profiled['first']):.2f} / "
            f"{statistics.mean(s['host_ms'] for s in profiled['last']):.2f} ms, device busy "
            f"{statistics.mean(s['device_ms'] for s in profiled['first']):.2f} / "
            f"{statistics.mean(s['device_ms'] for s in profiled['last']):.2f} ms on {name_and_limit}")
    remat = remat_path(run)
    log(f"save_attn_out: peak {remat['peak_gb']:.2f} GB, step {remat['step_s']:.4f} s (full remat: "
        f"{run['train_peak_gb']:.2f} GB, {run['step_s']:.4f} s) on {name_and_limit}")
    check_optimizers_against_cpu()
    check_fmri_mlp_against_cpu()
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")
    parallel_path(run, video, name_and_limit)
    # each kernel's launches from the path that runs it
    launches = {**video["launches"], "attention": run["attention"],
                "flash_masked": text["launches"]["flash_masked"],
                "flash_fast": bench["launches"]["flash_fast"],
                "flash_packed": bench["launches"]["flash_packed"],
                "flash_relkey": audio["launches"]["flash_relkey"]}
    for record in kernels:
        record["launches"] = launches[record["name"]]
    if not all(record["launches"] for record in kernels):
        raise SystemExit(f"a kernel was launched no time on its path: {launches}")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all on {name_and_limit}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
