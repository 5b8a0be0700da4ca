"""The w2v-BERT conformer's CUDA graphs on the card: tests that skip without one.

Full-width w2v-BERT 2.0 with seeded weights, bucketed chunks through
``TorchAudioBackbone.states_2hz``: the replayed states against the eager
forward's, bit for bit.  The eager reference is the same backbone with a
hook on the backbone module itself, which runs every stage eagerly.  This
file imports no JAX, so it runs on a machine with the card and without JAX
(the repository's ``conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest tests/test_torch_audio_graph_card.py -q -m card --noconftest
"""

import threading

import pytest
import torch

from algonauts2025_tpu_torch.features.audio import TARGET_SR, TorchAudioBackbone, stage_runs
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.models.backbones.wav2vec_bert import W2V_BERT_2_0, Wav2VecBertBackbone

STAGES = 1 + W2V_BERT_2_0.num_layers
#: chunk seconds and their 5 s buckets
CHUNKS = {"38.3": (38.3, 40.0), "52.6": (52.6, 55.0), "60": (60.0, 60.0), "27.1": (27.1, 30.0)}


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(25)
    return Wav2VecBertBackbone(W2V_BERT_2_0, device="cuda").init_random(gen)


def _chunk(name: str) -> tuple[torch.Tensor, int, int]:
    """A z-scored 16 kHz waveform of the chunk, its 2 Hz steps and its bucket's samples."""
    seconds, bucket = CHUNKS[name]
    gen = torch.Generator(device="cuda").manual_seed(int(seconds * 10))
    wav = torch.randn(int(seconds * TARGET_SR), generator=gen, device="cuda")
    return (wav - wav.mean()) / wav.std(), round(seconds * 2), int(bucket * TARGET_SR)


@torch.no_grad()
def _states(backbone: TorchAudioBackbone, name: str) -> torch.Tensor:
    return backbone.states_2hz(*_chunk(name)).clone()


@torch.no_grad()
def _eager(backbone: TorchAudioBackbone, name: str) -> torch.Tensor:
    """The chunk's states with every stage eager: a hook on the backbone."""
    handle = backbone.model.register_forward_pre_hook(lambda module, args: None)
    try:
        assert stage_runs(backbone.model) == [(0, STAGES, False)]
        return _states(backbone, name)
    finally:
        handle.remove()


@pytest.mark.card
def test_card_replay_in_another_order_is_bit_equal(model):
    """Captured largest first (no reallocation), replayed in another order:
    the same states as the eager forward, bit for bit; one capture a bucket,
    then replays."""
    backbone = TorchAudioBackbone(model)
    layers = W2V_BERT_2_0.num_layers
    eager = {name: _eager(backbone, name) for name in ("60", "52.6", "38.3")}
    assert backbone.counts["graph_captures"] == 0 and backbone.counts["eager_stages"] == 3 * STAGES
    backbone.reset_counts()
    launched, recorded = tf.launch_counts["flash_relkey"], tf.recorded_counts["flash_relkey"]
    first = {name: _states(backbone, name) for name in ("60", "52.6", "38.3")}
    assert backbone.counts["graph_captures"] == 3 and backbone.counts["graph_replays"] == 0
    assert backbone.counts["eager_stages"] == 3 * STAGES
    # row 8 launched a layer in each eager forward; each capture recorded as many, launching none
    assert tf.launch_counts["flash_relkey"] - launched == 3 * layers
    assert tf.recorded_counts["flash_relkey"] - recorded == 3 * layers
    replayed = {name: _states(backbone, name) for name in ("38.3", "60", "52.6", "38.3")}
    assert backbone.counts["graph_captures"] == 3 and backbone.counts["graph_replays"] == 4
    assert backbone.counts["eager_stages"] == 3 * STAGES and backbone.counts["chunks"] == 7
    assert tf.launch_counts["flash_relkey"] - launched == 7 * layers  # each replay counts its graph's record
    assert backbone.graphs.frames == 2999
    for name, want in eager.items():
        assert torch.isfinite(want).all()
        assert torch.equal(first[name], want), name
        assert torch.equal(replayed[name], want), name


@pytest.mark.card
def test_card_larger_bucket_reallocates_and_recaptures(model):
    """Smallest first: each larger bucket reallocates the buffers and drops
    every graph, so the smaller bucket captures again; all bit-equal."""
    backbone = TorchAudioBackbone(model)
    eager = {name: _eager(backbone, name) for name in ("27.1", "52.6", "60")}
    backbone.reset_counts()
    order = ["27.1", "52.6", "27.1", "27.1", "60", "52.6", "60", "52.6"]
    captures, frames = [], []
    for name in order:
        got = _states(backbone, name)
        assert torch.equal(got, eager[name]), name
        captures.append(backbone.counts["graph_captures"])
        frames.append(backbone.graphs.frames)
    # 27.1 captures; 52.6 grows (27.1's graph dropped); 27.1 captures again,
    # then replays; 60 grows; 52.6 captures again, then 60 and 52.6 replay
    assert captures == [1, 2, 3, 3, 4, 5, 5, 5]
    assert frames == [1499, 2749, 2749, 2749, 2999, 2999, 2999, 2999]
    assert backbone.counts["graph_replays"] == 3
    assert backbone.counts["eager_stages"] == 5 * STAGES


@pytest.mark.card
def test_card_hooked_first_layer_fires_every_chunk(model):
    """A forward pre-hook on layer 0's attention: the embed and layers 1-23
    are two graphs, layer 0 runs eagerly and its hook fires on every chunk,
    seeing the same input as on the eager path."""
    backbone = TorchAudioBackbone(model)
    eager = {name: _eager(backbone, name) for name in ("52.6", "38.3")}
    seen = []

    def take(module, args):
        seen.append(args[0].clone())

    handle = model.layers[0].self_attn.register_forward_pre_hook(take)
    try:
        assert stage_runs(model) == [(0, 1, True), (1, 2, False), (2, STAGES, True)]
        backbone.reset_counts()
        order = ["52.6", "38.3", "52.6", "38.3", "52.6"]
        for name in order:
            assert torch.equal(_states(backbone, name), eager[name]), name
        assert len(seen) == len(order)
        assert torch.equal(seen[2], seen[0]) and torch.equal(seen[4], seen[0]) and torch.equal(seen[3], seen[1])
        assert backbone.counts["graph_captures"] == 2 * 2 and backbone.counts["graph_replays"] == 3 * 2
        assert backbone.counts["eager_stages"] == 2 * STAGES + 3 * 1
    finally:
        handle.remove()


@pytest.mark.card
def test_card_profiler_sees_a_graph_captured_before_it(model):
    """A bucket captured before ``torch.profiler`` starts, replayed under it
    (as in the benchmark's traced window): the trace holds the graph's
    kernels, row 8's 24 among them, the same kernels as the eager forward's
    traced beside it."""
    from benchmark.common.trace import Tracer, span

    backbone = TorchAudioBackbone(model)
    _states(backbone, "38.3")
    _states(backbone, "38.3")
    torch.cuda.synchronize()
    tracer = Tracer(True)
    with tracer.window():  # every kernel inside a span, as the audio cell keeps them
        with span("replay"):
            _states(backbone, "38.3")
            torch.cuda.synchronize()
        with span("eager"):
            _eager(backbone, "38.3")
            torch.cuda.synchronize()
    assert backbone.counts["graph_captures"] == 1 and backbone.counts["graph_replays"] == 2
    trace = tracer.trace
    (start,) = [start for name, start, _ in trace.spans if name == "eager"]
    replay = [name for name, cat, _, end in trace.device if cat == "kernel" and end <= start]
    eager = [name for name, cat, begin, _ in trace.device if cat == "kernel" and begin >= start]
    assert sum("flash_relkey_kernel" in n for n in replay) == sum("flash_relkey_kernel" in n for n in eager) == 24
    assert len(eager) > 500 and set(replay) == set(eager) and abs(len(replay) - len(eager)) <= 2


def _round_on_the_card(mb: int, report: dict) -> None:
    """What the other features of ``prepare_features`` do on the card in
    their threads, once: allocate new device and page-locked memory, copy
    to page-locked memory, record, query and wait on an event, fetch to the
    host and wait on the stream.  ``report`` says how far it came."""
    try:
        report["call"] = "memory_stats"
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        report["call"] = "allocate"
        x = torch.full((mb << 18,), float(mb), device="cuda")  # larger than every cached block
        report["call"] = "page-locked allocate"
        host = torch.empty(mb << 10, pin_memory=True)
        report["call"] = "copy to page-locked"
        host.copy_(x[:mb << 10], non_blocking=True)
        report["call"] = "events"
        done = torch.cuda.Event()
        done.record()
        done.query()
        done.synchronize()
        report["call"] = "fetch"
        assert float(x[:1024].cpu().sum()) == 1024 * mb
        report["call"] = "stream synchronize"
        torch.cuda.current_stream().synchronize()
        report["new_segment"] = torch.cuda.memory_stats()["segment.all.allocated"] > segments
        report["call"] = "done"
    except Exception as exc:  # noqa: BLE001 - the test reports it
        report["error"] = f"{type(exc).__name__}: {exc}"


@pytest.mark.card
def test_card_capture_beside_a_thread_that_works_on_the_card(model, monkeypatch):
    """A fresh backbone captures its buckets while another thread works on
    the card as the other features of ``prepare_features`` do
    (``_round_on_the_card``), once before and once after each capture
    records its stages.  A device-wide synchronise or a draw from the
    default generator there would break a capture in any mode; no feature
    makes them.  No call fails in either thread, and the states equal the
    eager ones bit for bit."""
    eager = {name: _eager(TorchAudioBackbone(model), name) for name in ("60", "52.6", "38.3")}
    backbone = TorchAudioBackbone(model)
    capturing, rounds = [False], []
    capture, run = backbone.graphs._capture, backbone.graphs._run

    def flagged_capture(*args):
        capturing[0] = True
        try:
            return capture(*args)
        finally:
            capturing[0] = False

    def other_thread_round() -> None:
        report = {"mb": 512 + 64 * len(rounds)}  # 0.5 GB and up: above the 0.3 GB fp32 stack
        worker = threading.Thread(target=_round_on_the_card, args=(report["mb"], report))
        worker.start()
        worker.join(30)
        report["hung"] = worker.is_alive()
        rounds.append(report)

    def run_beside_rounds(*args, **kwargs):
        if not capturing[0]:
            return run(*args, **kwargs)
        other_thread_round()  # between capture_begin and capture_end, as the whole run below
        out = run(*args, **kwargs)
        other_thread_round()
        return out

    monkeypatch.setattr(backbone.graphs, "_capture", flagged_capture)
    monkeypatch.setattr(backbone.graphs, "_run", run_beside_rounds)
    got = [(name, _states(backbone, name)) for name in ("38.3", "60", "52.6", "38.3", "60", "52.6")]
    torch.cuda.synchronize()
    # 38.3 captures; 60 grows the buffers and captures; 52.6 captures, and
    # 38.3 again (dropped at the growth); then replays
    assert backbone.counts["graph_captures"] == 4 and backbone.counts["graph_replays"] == 2
    assert len(rounds) == 2 * 4 and all(r["call"] == "done" and r["new_segment"] and not r["hung"]
                                        for r in rounds), rounds
    for name, states in got:
        assert torch.equal(states, eager[name]), name
