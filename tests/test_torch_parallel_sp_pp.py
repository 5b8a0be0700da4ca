"""The port's sequence and pipeline parallelism against the JAX package's,
on the CPU: the twins of tests/test_parallel_sp_pp.py.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's ``LocalMesh`` puts every shard or stage on the CPU, which stands in
for them.  Tolerances: the port against itself keeps the JAX tests' own
(ring attention against one-device attention at fp32 roundoff, 2e-6; the
pipeline bitwise equal to a sequential run over the same microbatch
shapes); the port against JAX is held at fp32 roundoff of the same math
(the ring, the toy pipeline, the Llama stack: 2e-6 / 1e-6 / 1e-5), and the
tiny video backbone at the port's backbone tolerance (atol 3e-4, rtol
1e-3: the two resizes differ by ~1e-4, tests/test_torch_video.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from algonauts2025_tpu.parallel.mesh import get_mesh as jax_get_mesh
from algonauts2025_tpu.parallel.pipeline import pipeline_scan as jax_pipeline_scan
from algonauts2025_tpu.parallel.pipeline import pipelined_llama_states as jax_pipelined_llama
from algonauts2025_tpu.parallel.sequence import sequence_parallel_attention as jax_sp_attention
from algonauts2025_tpu_torch.models import llama_params_to_torch, vjepa2_params_to_torch
from algonauts2025_tpu_torch.parallel import (
    LocalMesh, local_mesh, pipeline_scan, pipelined_llama_states, sequence_parallel_attention,
)

CPU = torch.device("cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _ref_attention(q, k, v, causal=False):
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d**-0.5
    if causal:
        t = s.shape[-1]
        s = torch.where(torch.ones((t, t), dtype=torch.bool).tril(), s, -1e30)
    return torch.softmax(s, dim=-1) @ v.float()


class TestRingAttention:
    def test_matches_single_device_fp32(self):
        rng = np.random.default_rng(0)
        q, k, v = (rng.standard_normal((2, 3, 64, 16)).astype(np.float32) for _ in range(3))
        got = sequence_parallel_attention(_t(q), _t(k), _t(v), local_mesh(8, "data", "cpu"), "data")
        want = jax_sp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jax_get_mesh(8, model_parallel=1), "data")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        np.testing.assert_allclose(got.numpy(), _ref_attention(_t(q), _t(k), _t(v)).numpy(),
                                   atol=2e-6)

    def test_bf16_within_cast_noise(self):
        rng = np.random.default_rng(1)
        q, k, v = (rng.standard_normal((1, 2, 32, 8)).astype(np.float32) for _ in range(3))
        tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
        got = sequence_parallel_attention(tq, tk, tv, local_mesh(8, "data", "cpu"), "data")
        assert got.dtype == torch.bfloat16
        want = jax_sp_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                jax_get_mesh(8, model_parallel=1), "data")
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)
        np.testing.assert_allclose(got.float().numpy(), _ref_attention(tq, tk, tv).numpy(),
                                   atol=2e-2)

    @pytest.mark.parametrize("causal", [False, True])
    def test_large_scores_no_overflow(self, causal):
        # the running-max merge (and with causal the -1e30 mask) must survive
        # scores far outside exp's range
        rng = np.random.default_rng(2 if not causal else 5)
        q = (rng.standard_normal((1, 1, 16, 8)) * 40).astype(np.float32)
        k = (rng.standard_normal((1, 1, 16, 8)) * 40).astype(np.float32)
        v = rng.standard_normal((1, 1, 16, 8)).astype(np.float32)
        got = sequence_parallel_attention(_t(q), _t(k), _t(v), local_mesh(8, "data", "cpu"),
                                          "data", causal=causal)
        want = jax_sp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jax_get_mesh(8, model_parallel=1), "data", causal=causal)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got.numpy(), _ref_attention(_t(q), _t(k), _t(v), causal).numpy(),
                                   atol=2e-5)

    def test_causal_matches_single_device(self):
        rng = np.random.default_rng(4)
        q, k, v = (rng.standard_normal((2, 3, 64, 16)).astype(np.float32) for _ in range(3))
        got = sequence_parallel_attention(_t(q), _t(k), _t(v), local_mesh(8, "data", "cpu"),
                                          "data", causal=True)
        want = jax_sp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jax_get_mesh(8, model_parallel=1), "data", causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        np.testing.assert_allclose(got.numpy(), _ref_attention(_t(q), _t(k), _t(v), True).numpy(),
                                   atol=2e-6)
        # row 0 attends only to itself
        np.testing.assert_allclose(got[:, :, 0].numpy(), v[:, :, 0], atol=2e-6)

    def test_rejects_indivisible_seq(self):
        x = torch.zeros((1, 1, 12, 8))
        with pytest.raises(ValueError, match="not divisible"):
            sequence_parallel_attention(x, x, x, local_mesh(8, "data", "cpu"), "data")

    @pytest.mark.parametrize("causal", [False, True])
    def test_grad_matches_single_device(self, causal):
        """Autograd through the ring's copies: q/k/v gradients equal the
        JAX ring's and the one-device attention's at fp32 roundoff."""
        rng = np.random.default_rng(7)
        q, k, v = (rng.standard_normal((2, 2, 16, 8)).astype(np.float32) for _ in range(3))
        cot = rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
        mesh = local_mesh(4, "data", "cpu")
        qkv = [_t(x).requires_grad_() for x in (q, k, v)]
        (sequence_parallel_attention(*qkv, mesh, "data", causal=causal) * _t(cot)).sum().backward()
        ref = [_t(x).requires_grad_() for x in (q, k, v)]
        (_ref_attention(*ref, causal) * _t(cot)).sum().backward()

        jmesh = jax_get_mesh(4, model_parallel=1)

        def loss(q, k, v):
            return (jax_sp_attention(q, k, v, jmesh, "data", causal=causal) * cot).sum()

        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        for got, one, w in zip(qkv, ref, want):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-6)
            np.testing.assert_allclose(got.grad.numpy(), one.grad.numpy(), atol=5e-6)


def _toy_stack(rng, l, d):
    return {
        "w": (rng.standard_normal((l, d, d)) * 0.3).astype(np.float32),
        "b": (rng.standard_normal((l, d)) * 0.1).astype(np.float32),
    }


def _torch_tree(tree):
    return {k: _t(v) for k, v in tree.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _toy_layer(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def _jax_toy_layer(p, a):
    return jnp.tanh(a @ p["w"] + p["b"])


def _seq(params, x, depth, const=None):
    for i in range(depth):
        x = _toy_layer({k: v[i] for k, v in params.items()}, x)
        if const is not None:
            x = x + const
    return x


def _stages(n):
    return LocalMesh((CPU,) * n, "stage")


def _jax_stages(n):
    return Mesh(np.array(jax.devices()[:n]), ("stage",))


class TestPipelineScan:
    @pytest.mark.parametrize("n_micro", [1, 2, 3, 6])
    def test_bitwise_matches_sequential(self, n_micro):
        rng = np.random.default_rng(0)
        l, b, d = 16, 6, 8
        np_params = _toy_stack(rng, l, d)
        x_np = rng.standard_normal((b, d)).astype(np.float32)
        params, x = _torch_tree(np_params), _t(x_np)
        mb = b // n_micro

        def seq_ref(depth):
            return torch.cat([_seq(params, x[i : i + mb], depth) for i in range(0, b, mb)])

        out, states = pipeline_scan(_toy_layer, params, x, _stages(8), n_microbatches=n_micro,
                                    collect=lambda a: a)
        assert torch.equal(out, seq_ref(l))
        assert states.shape == (l, b, d)
        assert torch.equal(states[-1], out)
        assert torch.equal(states[4], seq_ref(5))
        want, want_states = jax_pipeline_scan(
            _jax_toy_layer, _jax_tree(np_params), jnp.asarray(x_np), _jax_stages(8),
            n_microbatches=n_micro, collect=lambda a: a,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(states.numpy(), np.asarray(want_states), atol=1e-6)

    def test_no_collect(self):
        rng = np.random.default_rng(1)
        np_params = _toy_stack(rng, 8, 4)
        x_np = rng.standard_normal((4, 4)).astype(np.float32)
        out, states = pipeline_scan(_toy_layer, _torch_tree(np_params), _t(x_np), _stages(8),
                                    n_microbatches=2)
        assert states is None
        assert torch.equal(out, torch.cat([_seq(_torch_tree(np_params), _t(x_np)[i : i + 2], 8)
                                           for i in (0, 2)]))
        want, _ = jax_pipeline_scan(_jax_toy_layer, _jax_tree(np_params), jnp.asarray(x_np),
                                    _jax_stages(8), n_microbatches=2)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)

    def test_pytree_activations(self):
        # activation = (x, const) tuple: the constant rides the pipeline
        rng = np.random.default_rng(2)
        np_params = _toy_stack(rng, 8, 4)
        x_np, c_np = (rng.standard_normal((4, 4)).astype(np.float32) for _ in range(2))
        params = _torch_tree(np_params)

        def layer(p, act):
            h, const = act
            return (_toy_layer(p, h) + const, const)

        (out, const_out), _ = pipeline_scan(layer, params, (_t(x_np), _t(c_np)), _stages(8),
                                            n_microbatches=2)
        ref = torch.cat([_seq(params, _t(x_np)[i : i + 2], 8, _t(c_np)[i : i + 2]) for i in (0, 2)])
        assert torch.equal(out, ref)
        assert torch.equal(const_out, _t(c_np))

        def jlayer(p, act):
            h, const = act
            return (_jax_toy_layer(p, h) + const, const)

        (want, _), _ = jax_pipeline_scan(jlayer, _jax_tree(np_params),
                                         (jnp.asarray(x_np), jnp.asarray(c_np)), _jax_stages(8),
                                         n_microbatches=2)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)

    def test_consts_match_flowing_pytree(self):
        # consts (which never travel between stages) must be bitwise equal
        # to flowing the same values
        rng = np.random.default_rng(3)
        np_params = _toy_stack(rng, 8, 4)
        x_np, c_np = (rng.standard_normal((4, 4)).astype(np.float32) for _ in range(2))
        params = _torch_tree(np_params)

        def layer_flow(p, act):
            h, const = act
            return (_toy_layer(p, h) + const, const)

        def layer_const(p, h, const):
            return _toy_layer(p, h) + const[0]

        (ref, _), ref_states = pipeline_scan(layer_flow, params, (_t(x_np), _t(c_np)), _stages(8),
                                             n_microbatches=2, collect=lambda act: act[0])
        out, states = pipeline_scan(layer_const, params, _t(x_np), _stages(8), n_microbatches=2,
                                    collect=lambda h: h, consts=(_t(c_np),))
        assert torch.equal(out, ref)
        assert torch.equal(states, ref_states)
        want, want_states = jax_pipeline_scan(
            lambda p, h, c: _jax_toy_layer(p, h) + c[0], _jax_tree(np_params), jnp.asarray(x_np),
            _jax_stages(8), n_microbatches=2, collect=lambda h: h, consts=(jnp.asarray(c_np),),
        )
        np.testing.assert_allclose(states.numpy(), np.asarray(want_states), atol=1e-6)

    @pytest.mark.parametrize("n_stage", [2, 4, 8])
    def test_fuzz_stage_counts(self, n_stage):
        # random depth/microbatch/width combos per stage count, a const
        # riding along; reference = sequential per-microbatch run
        rng = np.random.default_rng(100 + n_stage)
        for _ in range(3):
            l = n_stage * int(rng.integers(1, 4))
            d = int(rng.integers(2, 7))
            n_micro = int(rng.choice([1, 2, 4]))
            b = n_micro * int(rng.integers(1, 4))
            np_params = _toy_stack(rng, l, d)
            x_np, c_np = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
            params = _torch_tree(np_params)
            out, states = pipeline_scan(
                lambda p, h, c: _toy_layer(p, h) + c[0], params, _t(x_np), _stages(n_stage),
                n_microbatches=n_micro, collect=lambda h: h, consts=(_t(c_np),),
            )
            mb = b // n_micro
            ref = torch.cat([_seq(params, _t(x_np)[i : i + mb], l, _t(c_np)[i : i + mb])
                             for i in range(0, b, mb)])
            assert torch.equal(out, ref)
            assert states.shape == (l, b, d)
            want, _ = jax_pipeline_scan(
                lambda p, h, c: _jax_toy_layer(p, h) + c[0], _jax_tree(np_params),
                jnp.asarray(x_np), _jax_stages(n_stage), n_microbatches=n_micro,
                collect=lambda h: h, consts=(jnp.asarray(c_np),),
            )
            np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)

    def test_grad_matches_sequential(self):
        """Autograd through the schedule's copies: param and input grads,
        through the outputs and the collected states, equal the sequential
        run's and the JAX pipeline's."""
        rng = np.random.default_rng(42)
        l, b, d = 8, 4, 6
        np_params = _toy_stack(rng, l, d)
        x_np = rng.standard_normal((b, d)).astype(np.float32)
        cot = rng.standard_normal((l, b, d)).astype(np.float32)

        def grads(run):
            params = {k: v.requires_grad_() for k, v in _torch_tree(np_params).items()}
            x = _t(x_np).requires_grad_()
            out, states = run(params, x)
            ((out**2).sum() + (states * _t(cot)).sum()).backward()
            return [params["w"].grad, params["b"].grad, x.grad]

        def pipelined(params, x):
            return pipeline_scan(_toy_layer, params, x, _stages(4), n_microbatches=2,
                                 collect=lambda a: a)

        def sequential(params, x):
            outs, states = [], []
            for i in (0, 2):
                a, st = x[i : i + 2], []
                for j in range(l):
                    a = _toy_layer({k: v[j] for k, v in params.items()}, a)
                    st.append(a)
                outs.append(a)
                states.append(torch.stack(st))
            return torch.cat(outs), torch.cat(states, dim=1)

        got, ref = grads(pipelined), grads(sequential)
        jmesh = _jax_stages(4)

        def jloss(params, x):
            out, states = jax_pipeline_scan(_jax_toy_layer, params, x, jmesh, n_microbatches=2,
                                            collect=lambda a: a)
            return (out**2).sum() + (states * cot).sum()

        jw = jax.grad(jloss, argnums=(0, 1))(_jax_tree(np_params), jnp.asarray(x_np))
        want = [jw[0]["w"], jw[0]["b"], jw[1]]
        for g, r, w in zip(got, ref, want):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)

    def test_rejects_bad_shapes(self):
        params = _torch_tree(_toy_stack(np.random.default_rng(0), 12, 4))  # 12 % 8 != 0
        x = torch.zeros((4, 4))
        with pytest.raises(ValueError, match="not divisible"):
            pipeline_scan(_toy_layer, params, x, _stages(8))
        params = _torch_tree(_toy_stack(np.random.default_rng(0), 8, 4))
        with pytest.raises(ValueError, match="microbatch"):
            pipeline_scan(_toy_layer, params, x, _stages(8), n_microbatches=3)


# -- the video backbone with its window sequence split ---------------------------


def _windows(n_frames=16, b=2, crop=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (b, n_frames, crop, crop, 3), dtype=np.uint8)


def _video_pair(n_frames=16, quantize=False, n_shards=4, token_pool=False):
    """(JAX one-device, JAX sp, port one-device, port sp) tiny backbones from
    the same weights (the port's converted from the JAX ones)."""
    from algonauts2025_tpu.features import video as jvideo
    from algonauts2025_tpu.models.backbones.vjepa2 import VJEPA2Backbone as JBackbone
    from algonauts2025_tpu_torch.features import video as tvideo
    from algonauts2025_tpu_torch.models.backbones.vjepa2 import VJEPA2Backbone as TBackbone

    jmesh = Mesh(np.array(jax.devices()[:n_shards]), ("seq",))
    tmesh = local_mesh(n_shards, "seq", "cpu")
    tiny = jvideo.TinyVideoBackbone(hidden_size=64, num_layers=2, n_frames=n_frames,
                                    quantize=quantize)
    state = vjepa2_params_to_torch(tiny.params)
    if token_pool:
        jmodel = JBackbone(tiny.model.cfg, token_pool=True)
        jref = jvideo.JaxVideoBackbone(jmodel, tiny.params, n_frames=n_frames, crop_size=32)
        jsp = jvideo.JaxVideoBackbone(jmodel, tiny.params, n_frames=n_frames, crop_size=32,
                                      mesh=jmesh, sequence_parallel=True)
        base = tvideo.TinyVideoBackbone(hidden_size=64, num_layers=2, n_frames=n_frames,
                                        state_dict=state, device="cpu")
        pooled = TBackbone(base.model.cfg, token_pool=True)
        pooled.load_state_dict(state)
        tref = tvideo.TorchVideoBackbone(pooled, n_frames=n_frames, crop_size=32, device="cpu")
        tsp = tvideo.TorchVideoBackbone(pooled, n_frames=n_frames, crop_size=32, device="cpu",
                                        mesh=tmesh, sequence_parallel=True)
        return jref, jsp, tref, tsp
    jsp = jvideo.TinyVideoBackbone(hidden_size=64, num_layers=2, n_frames=n_frames,
                                   quantize=quantize, mesh=jmesh, sequence_parallel=True)
    kw = dict(hidden_size=64, num_layers=2, n_frames=n_frames, quantize=quantize,
              state_dict=state, device="cpu")
    return (tiny, jsp, tvideo.TinyVideoBackbone(**kw),
            tvideo.TinyVideoBackbone(**kw, mesh=tmesh, sequence_parallel=True))


class TestVideoSequenceParallel:
    def test_matches_single_device(self):
        jref, jsp, tref, tsp = _video_pair()
        w = _windows()
        got = tsp.encode_windows(w)
        np.testing.assert_allclose(got, tref.encode_windows(w), atol=2e-5)
        np.testing.assert_allclose(got, jsp.encode_windows(w), atol=3e-4, rtol=1e-3)

    def test_token_pooled_model_matches(self):
        """token_pool=True averages the shards' token means in the model:
        the product configuration for HF backbones."""
        jref, jsp, tref, tsp = _video_pair(token_pool=True, n_shards=8)
        w = _windows()
        got = tsp.encode_windows(w)
        np.testing.assert_allclose(got, tref.encode_windows(w), atol=2e-5)
        np.testing.assert_allclose(got, jsp.encode_windows(w), atol=3e-4, rtol=1e-3)

    def test_quantized_sp_matches_single_device(self):
        """w8a8 int8 under SP: the dynamic activation scales are per token
        row, hence shard-local."""
        jref, jsp, tref, tsp = _video_pair(quantize=True)
        w = _windows()
        got = tsp.encode_windows(w)
        np.testing.assert_allclose(got, tref.encode_windows(w), atol=5e-5)
        np.testing.assert_allclose(got, jsp.encode_windows(w), atol=3e-4, rtol=1e-3)

    def test_rejects_indivisible_frames(self):
        from algonauts2025_tpu.features.video import TinyVideoBackbone as JTiny
        from algonauts2025_tpu_torch.features.video import TinyVideoBackbone as TTiny

        # 8 frames / 4 shards = 1 tubelet a shard; over 8 shards tubelets would split
        with pytest.raises(ValueError, match="whole tubelets"):
            JTiny(n_frames=8, mesh=Mesh(np.array(jax.devices()), ("seq",)), sequence_parallel=True)
        with pytest.raises(ValueError, match="whole tubelets"):
            TTiny(n_frames=8, mesh=local_mesh(8, "seq", "cpu"), sequence_parallel=True,
                  device="cpu")
        TTiny(n_frames=8, mesh=local_mesh(4, "seq", "cpu"), sequence_parallel=True, device="cpu")

    def test_vjepa2_feature_sp_matches(self, tmp_path):
        """Through the FEATURE (decode, sliding windows, window_batch
        padding, cache writes): an injected SP backbone gives the plain
        one's arrays, and the JAX feature's."""
        from algonauts2025_tpu.cache.map_runner import MapInfra as JInfra
        from algonauts2025_tpu.core.events import Video as JVideo
        from algonauts2025_tpu.features import video as jvideo
        from algonauts2025_tpu_torch.cache.map_runner import MapInfra as TInfra
        from algonauts2025_tpu_torch.core.events import Video as TVideo
        from algonauts2025_tpu_torch.data.synthetic import _write_video
        from algonauts2025_tpu_torch.features import video as tvideo

        path = tmp_path / "v.mkv"
        assert _write_video(path, 6.0, np.random.default_rng(0), fps=8)
        jtiny = jvideo.TinyVideoBackbone(n_frames=16)
        state = vjepa2_params_to_torch(jtiny.params)

        def run(sub, backbone):
            fv = tvideo.VJEPA2(model_name="tiny-random", window_batch=2, device="cpu",
                               infra=TInfra(folder=str(tmp_path / sub)))
            fv.set_backbone(backbone)
            return [np.asarray(x) for x in fv._get_data([TVideo(start=0.0, timeline="tl",
                                                                 filepath=str(path))])]

        plain = run("plain", tvideo.TinyVideoBackbone(n_frames=16, state_dict=state, device="cpu"))
        sp = run("sp", tvideo.TinyVideoBackbone(n_frames=16, state_dict=state, device="cpu",
                                                mesh=local_mesh(4, "seq", "cpu"),
                                                sequence_parallel=True))
        jfv = jvideo.VJEPA2(model_name="tiny-random", window_batch=2,
                            infra=JInfra(folder=str(tmp_path / "jax")))
        jfv.set_backbone(jvideo.TinyVideoBackbone(
            n_frames=16, mesh=Mesh(np.array(jax.devices()[:4]), ("seq",)), sequence_parallel=True))
        want = [np.asarray(x) for x in jfv._get_data([JVideo(start=0.0, timeline="tl",
                                                              filepath=str(path))])]
        assert len(plain) == len(sp) == len(want) == 1
        np.testing.assert_allclose(sp[0], plain[0], atol=2e-5)
        np.testing.assert_allclose(sp[0], want[0], atol=3e-4, rtol=1e-3)

    def test_feature_config_knob(self):
        """``VJEPA2(sequence_parallel=k)`` reaches SP from plain config, and
        the knob is topology only (excluded from the cache uid, as in JAX)."""
        from algonauts2025_tpu.config.uid import config_uid as jax_uid
        from algonauts2025_tpu.features.video import VJEPA2 as JVJEPA2
        from algonauts2025_tpu_torch.config.uid import config_uid
        from algonauts2025_tpu_torch.features.video import VJEPA2

        feat = VJEPA2(model_name="tiny-random", sequence_parallel=4, device="cpu",
                      infra={"folder": None})
        assert feat.backbone.sequence_parallel
        assert feat.backbone.mesh.shape["seq"] == 4
        base = VJEPA2(model_name="tiny-random", device="cpu", infra={"folder": None})
        assert config_uid(feat) == config_uid(base)
        jfeat = JVJEPA2(model_name="tiny-random", sequence_parallel=4, infra={"folder": None})
        assert jax_uid(jfeat) == config_uid(feat)


# -- the Llama stack split into stages ------------------------------------------


def _llama_pair(num_layers=4, vocab=64, hidden=32, inter=48, heads=4, kv=2, hd=8, seed=0):
    from algonauts2025_tpu.models.backbones import llama as jl
    from algonauts2025_tpu_torch.models.backbones import llama as tl

    kw = dict(vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
              num_layers=num_layers, num_heads=heads, num_kv_heads=kv, head_dim=hd)
    jcfg = jl.LlamaConfig(**kw, dtype=jnp.float32)
    jmodel = jl.LlamaBackbone(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = tl.LlamaConfig(**kw, dtype=torch.float32)
    tmodel = tl.LlamaBackbone(tcfg)
    tmodel.load_state_dict(llama_params_to_torch(params))
    return jcfg, jmodel, params, tcfg, tmodel.eval()


class TestPipelinedLlama:
    @torch.no_grad()
    def test_bitwise_matches_scanned_backbone(self):
        jcfg, jmodel, params, tcfg, tmodel = _llama_pair()
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 64, (4, 12))
        lengths = np.array([12, 9, 7, 12])
        mask = (np.arange(12)[None] < lengths[:, None]).astype(np.int32)
        ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
        got = pipelined_llama_states(tcfg, tmodel, ids_t, mask_t, _stages(4), n_microbatches=2)
        # bitwise against the one-device backbone over the same microbatch shapes
        ref = torch.cat([tmodel(ids_t[i : i + 2], mask_t[i : i + 2]) for i in (0, 2)], dim=1)
        assert got.shape == ref.shape == (5, 4, 12, 32)
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
        want = jax_pipelined_llama(jcfg, params, jnp.asarray(ids), jnp.asarray(mask),
                                   _jax_stages(4), n_microbatches=2)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
        np.testing.assert_allclose(np.nan_to_num(got.numpy()), np.nan_to_num(np.asarray(want)),
                                   atol=1e-5)

    def test_text_backbone_pipeline_option(self):
        """``TorchTextBackbone(pipeline_mesh=)``: every layer lives once on
        its stage's device, and every public path (hidden, pooled, chain)
        gives the one-device backbone's values and the JAX pipelined one's."""
        from algonauts2025_tpu.features.text import TinyTextBackbone as JTiny
        from algonauts2025_tpu_torch.features.text import TinyTextBackbone as TTiny

        jpp = JTiny(num_layers=4, seed=0, pipeline_mesh=_jax_stages(4))
        state = llama_params_to_torch(JTiny(num_layers=4, seed=0).params)
        ref = TTiny(num_layers=4, state_dict=state, device="cpu")
        pp = TTiny(num_layers=4, state_dict=state, device="cpu", pipeline_mesh=_stages(4))
        assert pp.pipeline_mesh.shape["stage"] == 4
        assert all(p.device == CPU for p in pp.model.parameters())
        texts = ["the cat sat", "on the mat today", "a", "longer sentence here ok"]
        ids, mask = ref.encode(texts)
        np.testing.assert_allclose(pp.hidden_states(ids, mask), ref.hidden_states(ids, mask),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(pp.hidden_states(ids, mask), jpp.hidden_states(ids, mask),
                                   rtol=0, atol=1e-5)
        spans = np.array([1, 2, 1, 3])
        np.testing.assert_allclose(pp.pooled_states(ids, mask, spans),
                                   ref.pooled_states(ids, mask, spans), rtol=0, atol=1e-5)
        chain = ref.chain_tokenize(["a b", "a b c", "a b c d e"])
        np.testing.assert_allclose(np.asarray(pp.pooled_states_chain_async(chain, [1, 1, 2])),
                                   np.asarray(ref.pooled_states_chain_async(chain, [1, 1, 2])),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(pp.pooled_states_chain_async(chain, [1, 1, 2])),
                                   np.asarray(jpp.pooled_states_chain_async(chain, [1, 1, 2])),
                                   rtol=0, atol=1e-5)

    def test_llama3p2_feature_pipelined_matches(self, tmp_path):
        """The LLAMA3p2 feature with an injected pipelined backbone gives the
        plain one's arrays, and the JAX feature's with its pipelined one."""
        from algonauts2025_tpu.cache.map_runner import MapInfra as JInfra
        from algonauts2025_tpu.core.events import Word as JWord
        from algonauts2025_tpu.features.text import LLAMA3p2 as JLLAMA
        from algonauts2025_tpu.features.text import TinyTextBackbone as JTiny
        from algonauts2025_tpu_torch.cache.map_runner import MapInfra as TInfra
        from algonauts2025_tpu_torch.core.events import Word as TWord
        from algonauts2025_tpu_torch.features.text import LLAMA3p2, TinyTextBackbone

        words = ["hello", "there", "general", "kenobi", "today"]
        contexts = [" ".join(words[: i + 1]) for i in range(len(words))]

        def events(cls):
            return [cls(start=float(i), duration=0.5, timeline="tl", text=w, context=c)
                    for i, (w, c) in enumerate(zip(words, contexts))]

        state = llama_params_to_torch(JTiny(num_layers=4, seed=0).params)

        def run(sub, backbone):
            ft = LLAMA3p2(model_name="tiny-random", device="cpu",
                          infra=TInfra(folder=str(tmp_path / sub)))
            ft.set_backbone(backbone)
            return [np.asarray(x) for x in ft._get_data(events(TWord))]

        plain = run("plain", TinyTextBackbone(num_layers=4, state_dict=state, device="cpu"))
        piped = run("piped", TinyTextBackbone(num_layers=4, state_dict=state, device="cpu",
                                              pipeline_mesh=_stages(4)))
        jft = JLLAMA(model_name="tiny-random", infra=JInfra(folder=str(tmp_path / "jax")))
        jft.set_backbone(JTiny(num_layers=4, seed=0, pipeline_mesh=_jax_stages(4)))
        want = [np.asarray(x) for x in jft._get_data(events(JWord))]
        assert len(plain) == len(piped) == len(want) == 5
        for a, b, w in zip(plain, piped, want):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
            np.testing.assert_allclose(b, w, rtol=0, atol=1e-5)

    @torch.no_grad()
    def test_left_padded_rows_poisoned(self):
        # the right-pad NaN contract survives the pipelined path
        jcfg, jmodel, params, tcfg, tmodel = _llama_pair(
            num_layers=2, vocab=32, hidden=16, inter=24, heads=2, kv=1, hd=8)
        ids = np.zeros((2, 8), np.int32)
        mask = np.asarray([[1] * 8, [0, 0, 1, 1, 1, 1, 1, 1]], np.int32)
        out = pipelined_llama_states(tcfg, tmodel, torch.from_numpy(ids).long(),
                                     torch.from_numpy(mask), _stages(2), n_microbatches=2)
        assert not torch.isnan(out[:, 0]).any()
        assert torch.isnan(out[1:, 1]).all()
        want = jax_pipelined_llama(jcfg, params, jnp.asarray(ids), jnp.asarray(mask),
                                   _jax_stages(2), n_microbatches=2)
        np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(want)))
