"""The port's twin of tests/test_data_layer.py: the same cases over the copies
in algonauts2025_tpu_torch. The grid and test-config cases wait for their
modules (ROADMAP queue 1 item 5); the audio feature in the prepare_features
cases is the text feature here (item 2).

Data layer: text matching, enhancers, study loader, dataset batching."""

import numpy as np
import pandas as pd
import pytest

from algonauts2025_tpu_torch.data import text_match
from algonauts2025_tpu_torch.data.dataset import SegmentData, SegmentDataset
from algonauts2025_tpu_torch.data.enhancers import (
    AddContextToWords,
    AddSentenceToWords,
    AddText,
    BaseEnhancer,
    RemoveMissing,
)
from algonauts2025_tpu_torch.data.study import StudyLoader, TIMELINES
from algonauts2025_tpu_torch.data.synthetic import make_synthetic_study
from algonauts2025_tpu_torch.core import list_segments, validate_events


def test_split_sentences():
    text = "Hello there. How are you? Dr. Smith is here. Fine!"
    sents = text_match.split_sentences(text)
    texts = [s.text.strip() for s in sents]
    assert texts == ["Hello there.", "How are you?", "Dr. Smith is here.", "Fine!"]
    # offsets cover the text
    assert sents[0].start == 0
    assert sents[-1].end == len(text)


def test_match_list_identity():
    a, b = text_match.match_list(["x", "y", "z"], ["x", "z"])
    assert list(a) == [0, 2]
    assert list(b) == [0, 1]


def test_match_text_words():
    text = "Hello world. This is fine."
    words = ["hello", "world", "this", "is", "fine"]
    info = text_match.match_text_words(text, words)
    assert info[0]["sentence"].strip() == "Hello world."
    assert info[0]["sentence_char"] == 0
    assert info[1]["sentence_char"] == 6
    assert info[2]["sentence"].strip() == "This is fine."


def test_enhancer_registry_discriminated_union():
    enh = BaseEnhancer.model_validate({"name": "AddText"})
    assert isinstance(enh, AddText)
    with pytest.raises(Exception):
        BaseEnhancer.model_validate({"name": "Nope"})


def _word_df():
    words = "hello world this is a test sentence".split()
    rows = []
    t = 0.0
    for w in words:
        rows.append(
            dict(type="Word", text=w, start=t, duration=0.3, timeline="tl",
                 language="english", split="train")
        )
        t += 0.5
    return pd.DataFrame(rows)


def test_enhancer_chain():
    events = validate_events(_word_df())
    events = AddText()(events)
    assert "Text" in events.type.unique()
    events = AddSentenceToWords(max_unmatched_ratio=0.1)(events)
    words = events[events.type == "Word"]
    assert (words.sentence.str.len() > 0).mean() > 0.8
    events = AddContextToWords(sentence_only=False, max_context_len=100)(events)
    words = events[events.type == "Word"]
    ctx = words.context.tolist()
    assert ctx[1].lower().startswith("hello")
    assert len(ctx[-1]) >= len(ctx[1])
    n_before = len(events)
    events = RemoveMissing()(events)
    assert len(events) <= n_before


def test_synthetic_study_build(tmp_path):
    study_path = make_synthetic_study(tmp_path, with_video=False)
    loader = StudyLoader(
        path=study_path,
        query="subject_timeline_index<2",
        enhancers=[
            {"name": "AddText"},
            {"name": "AddSentenceToWords", "max_unmatched_ratio": 0.2},
            {"name": "AddContextToWords", "sentence_only": False,
             "max_context_len": 64},
            {"name": "RemoveMissing"},
        ],
        infra={"folder": str(tmp_path / "cache")},
    )
    events = loader.build()
    assert set(events.type.unique()) >= {"Word", "Text", "Fmri"}
    core = events[events.type.isin(["Word", "Text", "Fmri", "Sound", "Video"])]
    assert core.split.isin(["train", "test"]).all()
    # fmri events read through their method: URI
    fmri_rows = events[events.type == "Fmri"]
    assert len(fmri_rows) >= 1
    from algonauts2025_tpu_torch.core import Event

    fmri_ev = Event.from_dict(fmri_rows.iloc[0].to_dict())
    data = fmri_ev.read()
    assert data.shape[0] == 64  # parcels first, time last
    # cached rebuild gives the same events
    events2 = StudyLoader(**loader.model_dump()).build()
    assert len(events2) == len(events)


def test_segment_dataset_batching(tmp_path):
    study_path = make_synthetic_study(tmp_path, with_video=False)
    loader = StudyLoader(path=study_path, query="subject_timeline_index<2")
    events = loader.build()
    train = events[events.split == "train"]
    segments = list_segments(train)
    assert segments

    class CountFeature:
        frequency = 2.0

        def __call__(self, events, start, duration, trigger=None):
            n = max(1, int(round(duration * 2.0)))
            return np.full((3, n), float(len(events)), dtype=np.float32)

    ds = SegmentDataset({"x": CountFeature()}, segments, pad_duration=149.0)
    item = ds[0]
    assert item["x"].shape == (3, 298)
    batches = list(ds.batches(batch_size=2, shuffle=True, seed=0))
    assert all(b.data["x"].shape[1:] == (3, 298) for b in batches)
    total = sum(b.batch_size for b in batches)
    assert total == len(ds)
    one = ds.as_one_batch()
    assert one.batch_size == len(ds)

    # threaded assembly gives the same content
    b_threaded = list(ds.batches(batch_size=2, num_workers=2))
    b_serial = list(ds.batches(batch_size=2))
    for bt, bs in zip(b_threaded, b_serial):
        np.testing.assert_array_equal(bt.data["x"], bs.data["x"])


def test_assign_sentence_split():
    from algonauts2025_tpu_torch.data.enhancers import (
        AddSentenceToWords,
        AddText,
        AssignSentenceSplit,
    )

    words = ("the quick brown fox jumps over the lazy dog and then runs far "
             "away into the deep dark woods tonight").split()
    rows = []
    t = 0.0
    for w in words:
        rows.append(dict(type="Word", text=w, start=t, duration=0.3,
                         timeline="tl", language="english"))
        t += 0.5
    events = validate_events(pd.DataFrame(rows))
    events = AddText()(events)
    events = AddSentenceToWords(max_unmatched_ratio=0.5)(events)
    out = AssignSentenceSplit(ratios=(0.6, 0.2, 0.2), max_unmatched_ratio=0.5)(events)
    words_out = out[out.type == "Word"]
    assigned = words_out.split.dropna()
    assert set(assigned) <= {"train", "val", "test", "undefined"}
    # deterministic: same input -> same assignment
    out2 = AssignSentenceSplit(ratios=(0.6, 0.2, 0.2), max_unmatched_ratio=0.5)(events)
    assert list(out2[out2.type == "Word"].split) == list(words_out.split)


def test_fmri_zscore_sample():
    from algonauts2025_tpu_torch.features.neuro import zscore_sample

    rng = np.random.default_rng(0)
    data = rng.standard_normal((5, 40)).astype(np.float32) * 3 + 2
    z = zscore_sample(data)
    np.testing.assert_allclose(z.mean(axis=-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(z.std(axis=-1, ddof=1), 1.0, atol=1e-4)
    # constant rows stay finite
    const = np.ones((2, 10), np.float32)
    assert np.isfinite(zscore_sample(const)).all()


def test_assign_split_trailing_single_word_sentence():
    """A transcript ending in a one-word sentence must not crash the split
    assignment (the extraction quirk gives it no Sentence event)."""
    import numpy as np

    from algonauts2025_tpu_torch.data.enhancers import AssignSentenceSplit

    rows = []
    t = 0.0
    for sent in ("Hello world. ", "Hello world. ", "Bye. "):
        char = 0
        for w in sent.strip().rstrip(".").split():
            rows.append(dict(type="Word", text=w, start=round(t, 2), duration=0.2,
                             timeline="tl", sentence=sent, sentence_char=float(char),
                             language="english"))
            char += len(w) + 1
            t += 0.4
    frame = pd.DataFrame(rows)
    out = AssignSentenceSplit(ratios=(0.7, 0.2, 0.1), seed=1)(frame)
    assert out.loc[out.text == "Bye", "split"].tolist() == ["undefined"]
    assert set(out.split) <= {"train", "val", "test", "undefined"}


def test_assign_split_no_words_is_noop():
    from algonauts2025_tpu_torch.data.enhancers import AssignSentenceSplit

    frame = pd.DataFrame([dict(type="Video", start=0.0, duration=5.0,
                               timeline="tl", filepath="x", sentence="")])
    out = AssignSentenceSplit()(frame.copy())
    assert len(out) == 1


def test_sentences_not_duplicated_across_contexts(tmp_path):
    """Two Text contexts on one timeline: earlier contexts' sentences must
    appear once (the reference re-harvests them per context)."""
    import numpy as np

    from algonauts2025_tpu_torch.data.enhancers import AddSentenceToWords

    rows = []
    t = 0.0
    for ctx_text in ("Hello world.", "Good bye now."):
        words = ctx_text.rstrip(".").split()
        start = t
        for w in words:
            rows.append(dict(type="Word", text=w, start=round(t, 2), duration=0.2,
                             timeline="tl", language="english"))
            t += 0.4
        rows.append(dict(type="Text", text=ctx_text, start=start - 0.01,
                         duration=t - start + 0.02, timeline="tl",
                         language="english"))
        t += 1.0
    out = AddSentenceToWords(max_unmatched_ratio=0.9)(pd.DataFrame(rows))
    sentences = out[out.type == "Sentence"]
    texts = sentences.text.tolist()
    assert len(texts) == len(set(texts)), texts  # no duplicates


def test_resolve_root_shared_by_discovery_and_submission():
    """write_submission must resolve the dataset root exactly the way
    timeline discovery does (nested path/<Study> directory), or a
    parent-path study trains fine and crashes at submission time."""
    from algonauts2025_tpu_torch.data.study import BaseData

    class DemoStudy(BaseData):
        @classmethod
        def _iter_timelines(cls, path):
            yield cls(timeline="t0", subject="s1", filepath=str(path))

    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as td:
        nested = Path(td) / "demostudy"
        nested.mkdir()
        assert DemoStudy.resolve_root(td) == nested
        assert DemoStudy.resolve_root(nested) == nested
        # no nested dir -> the path itself
        with tempfile.TemporaryDirectory() as td2:
            assert DemoStudy.resolve_root(td2) == Path(td2)


def test_segment_dataset_drop_remainder():
    """drop_remainder=True yields only full batches (the Data.drop_last
    knob routes here for single-executable TPU epochs)."""
    import numpy as np

    from algonauts2025_tpu_torch.data.dataset import SegmentDataset

    class _Feat:
        def __call__(self, events, start, duration):
            return np.zeros((2, 3), np.float32)

        def prepare(self, events):
            pass

    segs = [object() for _ in range(10)]

    class _DS(SegmentDataset):
        def __getitem__(self, i):
            return {"x": np.full((1, 2), float(i), np.float32)}

    ds = _DS({}, segs, pad_duration=None)
    full = list(ds.batches(batch_size=4))
    assert [b.data["x"].shape[0] for b in full] == [4, 4, 2]
    dropped = list(ds.batches(batch_size=4, drop_remainder=True))
    assert [b.data["x"].shape[0] for b in dropped] == [4, 4]
    # shuffle keeps the drop-to-multiple contract
    dropped_sh = list(ds.batches(batch_size=4, shuffle=True, seed=0, drop_remainder=True))
    assert [b.data["x"].shape[0] for b in dropped_sh] == [4, 4]


def test_prepare_features_overlap():
    """overlap=True runs local features concurrently (threads), overlap=False
    strictly serially; both prepare everything and propagate exceptions."""
    import threading
    import time as _time

    from algonauts2025_tpu_torch.data.helpers import prepare_features

    class _Feat:
        def __init__(self):
            self.thread = None
            self.t_span = None

        def prepare(self, events):
            self.thread = threading.current_thread().name
            t0 = _time.time()
            _time.sleep(0.2)
            self.t_span = (t0, _time.time())

    feats = [_Feat(), _Feat(), _Feat()]
    t0 = _time.time()
    prepare_features(feats, [], overlap=True)
    wall = _time.time() - t0
    assert all(f.t_span is not None for f in feats)
    # three 0.2 s prepares overlapped: wall well under the serial 0.6 s
    assert wall < 0.45, f"overlapped prepare took {wall:.2f}s (serial ~0.6s)"

    serial = [_Feat(), _Feat(), _Feat()]
    prepare_features(serial, [], overlap=False)
    assert all(f.t_span is not None for f in serial)
    # serial: no two spans overlap
    spans = sorted(f.t_span for f in serial)
    assert all(a[1] <= b[0] + 1e-3 for a, b in zip(spans, spans[1:]))

    class _Boom(_Feat):
        def prepare(self, events):
            raise RuntimeError("boom")

    import pytest as _pytest

    with _pytest.raises(RuntimeError, match="boom"):
        prepare_features([_Feat(), _Boom()], [], overlap=True)


def test_prepare_features_overlap_identical_caches(tmp_path):
    """Overlapped prepare writes byte-identical per-feature caches to the
    serial order (two real tiny text features of different cache uids,
    on-disk ArrayStores)."""
    import numpy as np

    from algonauts2025_tpu_torch.cache.map_runner import MapInfra
    from algonauts2025_tpu_torch.core.events import Word
    from algonauts2025_tpu_torch.data.helpers import prepare_features
    from algonauts2025_tpu_torch.features.text import LLAMA3p2, TinyTextBackbone

    events = [
        Word(start=0.5 * i, duration=0.4, text=w, context=" ".join(["a b c"] * (i + 1)),
             timeline="tl")
        for i, w in enumerate(["a", "b", "c"])
    ]
    text_bb = TinyTextBackbone(device="cpu")

    def run(mode_dir, overlap):
        feats = []
        for max_tokens in (1024, 4):
            f = LLAMA3p2(model_name="tiny-random", max_context_tokens=max_tokens,
                         infra=MapInfra(folder=str(mode_dir)))
            f.set_backbone(text_bb)
            feats.append(f)
        prepare_features({"long": feats[0], "short": feats[1]}, events, overlap=overlap)
        # read back through the same cached path
        return [np.asarray(x) for f in feats for x in f._get_data(events)]

    ser = run(tmp_path / "serial", overlap=False)
    ovl = run(tmp_path / "overlap", overlap=True)
    assert len(ser) == 6
    for a, b in zip(ser, ovl):
        np.testing.assert_array_equal(a, b)


def _word_events(timeline: str, words: list[str]):
    from algonauts2025_tpu_torch.core.events import Word

    return [Word(start=0.5 * i, duration=0.4, text=w, context=" ".join(words[: i + 1]),
                 timeline=timeline) for i, w in enumerate(words)]


def test_prepare_features_releases_backbones_on_prepare_failure(tmp_path):
    """When one feature's prepare raises, backbones already built by the
    OTHERS are still released (r4 review: the release loop was skipped on
    failure, leaving the frozen params squatting device memory through a
    caller's retry)."""
    from algonauts2025_tpu_torch.cache.map_runner import MapInfra
    from algonauts2025_tpu_torch.data.helpers import prepare_features
    from algonauts2025_tpu_torch.features.text import LLAMA3p2

    events = _word_events("tl", ["hello", "there"])
    lazy = LLAMA3p2(model_name="tiny-random", device="cpu",
                    infra=MapInfra(folder=str(tmp_path / "c1")))

    class Exploding:
        def prepare(self, events):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        prepare_features([lazy, Exploding()], events)
    assert lazy._backbone is None, "built backbone must be released on failure"


def test_prepare_features_releases_owned_backbones(tmp_path):
    """After prepare, a LAZILY-built backbone is dropped (its device params
    are the biggest device-memory tenant; training needs the room) while
    an INJECTED one is kept; dataset-time reads keep working from the
    cache, and a genuine later miss transparently rebuilds the same seeded
    backbone."""
    import numpy as np

    from algonauts2025_tpu_torch.cache.map_runner import MapInfra
    from algonauts2025_tpu_torch.data.helpers import prepare_features
    from algonauts2025_tpu_torch.features.text import LLAMA3p2, TinyTextBackbone

    events = _word_events("tl", ["hello", "there", "friend"])
    lazy = LLAMA3p2(model_name="tiny-random", device="cpu",
                    infra=MapInfra(folder=str(tmp_path / "c1")))
    injected = LLAMA3p2(model_name="tiny-random", device="cpu",
                        infra=MapInfra(folder=str(tmp_path / "c2")))
    injected.set_backbone(TinyTextBackbone(hidden_size=32, num_layers=1, device="cpu"))
    prepare_features([lazy, injected], events)
    assert lazy._backbone is None, "lazily-built backbone must be released"
    assert injected._backbone is not None, "injected backbone must be kept"
    # cached read works without a backbone
    out = lazy(events, start=0.0, duration=1.0)
    assert out.shape[-1] == 2  # 1.0 s at 2 Hz
    # a genuine miss (new events) rebuilds the identical seeded backbone
    more = _word_events("tl2", ["misty", "hills"])
    vals = [np.asarray(x) for x in lazy._get_data(more)]
    assert lazy._backbone is not None  # rebuilt on demand
    fresh = LLAMA3p2(model_name="tiny-random", device="cpu",
                     infra=MapInfra(folder=str(tmp_path / "c3")))
    ref = [np.asarray(x) for x in fresh._get_data(more)]
    for a, b in zip(vals, ref):
        np.testing.assert_array_equal(a, b)


def test_assign_sentence_split_no_words_cleans_synthetic_timeline():
    """The audio-only early return must drop the injected '#foo#' timeline
    column (r4 review: it leaked into the caller's frame)."""
    import pandas as pd

    from algonauts2025_tpu_torch.data.enhancers import AssignSentenceSplit

    df = pd.DataFrame(
        [{"type": "Sound", "start": 0.0, "duration": 1.0, "filepath": "x.wav"}]
    )
    out = AssignSentenceSplit(name="AssignSentenceSplit")(df)
    assert "timeline" not in out.columns
    assert "timeline" not in df.columns


def test_demux_audio_no_partial_wav_on_failure(tmp_path, monkeypatch):
    """An interrupted/failed ffmpeg must never leave a partial wav at the
    final path where later runs would trust it (r4 review)."""
    import algonauts2025_tpu_torch.data.enhancers as enh

    wav = tmp_path / "movie.wav"

    fake = tmp_path / "ffmpeg"
    # writes a partial file to its output path (argv[-1]) then fails
    fake.write_text("#!/bin/sh\necho partial > \"${@: -1}\"\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr("shutil.which", lambda name: str(fake))
    ok = enh._demux_audio(tmp_path / "movie.mkv", wav)
    assert not ok
    assert not wav.exists(), "partial wav left at the final path"
    assert not list(tmp_path.glob("*.tmp*.wav")), "temp file not cleaned up"


def test_as_one_batch_empty_dataset_raises():
    ds = SegmentDataset(features={}, segments=[])
    with pytest.raises(ValueError, match="EMPTY dataset"):
        ds.as_one_batch()
