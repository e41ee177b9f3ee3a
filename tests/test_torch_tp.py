"""The ``model`` axis of the port in one process: the head and vocabulary
layouts, the sharded dim and global shape of every leaf, the slicing of
global parameters to each model rank and back, the sinusoidal positions
of each sequence-parallel slice, the mesh's coordinates, and the
refusal of a ``tp`` the recurrent blocks' heads do not split over (TP
checkpoints are ``test_torch_ckpt_sharded.py``'s).
Each layout is held against the JAX package's (``layers.head_layout``,
``layers.pad_vocab``, ``Model.abstract_init`` specs); the multi-rank
steps are ``test_torch_tp_step.py`` (dense, MoE),
``test_torch_tp_families.py`` (audio, vlm) and
``test_torch_tp_recurrent.py`` (hybrid, ssm)."""
import dataclasses

import numpy as np
import pytest

DENSE_MOE = ("tinyllama-1.1b", "granite-8b", "mistral-nemo-12b", "qwen3-32b",
             "qwen2-moe-a2.7b", "arctic-480b")
AUDIO_VLM = ("seamless-m4t-medium", "qwen2-vl-7b")
#: the recurrent families (hybrid, ssm)
OTHER = ("zamba2-2.7b", "xlstm-350m")
ALL = DENSE_MOE + AUDIO_VLM + OTHER


def _layout_or_error(fn, *args):
    try:
        return dataclasses.astuple(fn(*args))
    except (AssertionError, ValueError):
        return "refused"


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_head_layout_matches_jax(name, tp):
    from repro.configs import base as jcfgs
    from repro.models.layers import head_layout as jlayout
    from repro_torch.models.layers import head_layout
    cfg = jcfgs.get(name)
    args = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp)
    assert _layout_or_error(head_layout, *args) == \
        _layout_or_error(jlayout, *args)


def test_padded_head_layout_matches_jax():
    """Six q heads over two kv heads at tp 4: each rank holds two q heads
    of one group, the groups padded from 3 to 4 (``n_h_pad`` 8), the kv
    weights replicated; the padded heads are masked."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    lay = tl.head_layout(6, 2, 32, 4)
    assert dataclasses.astuple(lay) == \
        dataclasses.astuple(jl.head_layout(6, 2, 32, 4))
    assert (lay.n_h_pad, lay.L, lay.g_pad, lay.kv_replicated) == \
        (8, 2, 4, True) and lay.padded
    masks = [tl.local_head_mask(lay, m).tolist() for m in range(4)]
    assert masks == [[True, True], [True, False], [True, True],
                     [True, False]]
    import torch
    kv = torch.arange(2 * 3 * 2 * 4.0).reshape(2, 3, 2, 4)
    assert [int(tl.local_kv_slice(kv, lay, m)[0, 0, 0, 0]) for m in
            range(4)] == [0, 0, 4, 4]


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 16])
def test_pad_vocab_matches_jax(tp):
    from repro.models.layers import pad_vocab as jpad
    from repro_torch.models.layers import pad_vocab
    for vocab in (512, 32000, 49152, 131072, 151936, 50257):
        assert pad_vocab(vocab, tp) == jpad(vocab, tp)


def _jax_specs(cfg, tp, fsdp):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.models import Model as JModel
    from repro.models.layers import ShardCtx as JShardCtx
    shapes, specs = JModel(cfg).abstract_init(JShardCtx(
        tp=tp, fsdp_axes=("data",) if fsdp else ()))
    dims, glob = {}, {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        name = ".".join(str(k.key) for k in path)
        dims[name] = {ax: [i for i, e in enumerate(s) if e is not None
                           and ax in (e if isinstance(e, tuple) else (e,))]
                      for ax in ("model", "data")}
    for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        glob[".".join(str(k.key) for k in path)] = tuple(x.shape)
    return dims, glob


@pytest.mark.parametrize("name", DENSE_MOE + AUDIO_VLM)
@pytest.mark.parametrize("tp, full", [(2, False), (4, False), (16, True)])
def test_tp_dims_and_shapes_match_jax_specs(name, tp, full):
    """Every leaf's global shape at ``tp`` (padded vocabulary, q heads and
    experts) and the dim ``model`` shards, leaf by leaf in leaf order,
    against JAX's ``abstract_init`` at ``ShardCtx(tp=tp)`` with FSDP over
    ``data``; the local shape of a rank of ``data 2 x model tp`` divides
    both dims, as JAX's ``localize`` does."""
    from repro.configs import base as jcfgs
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import (Model, param_dims, param_layout,
                                          tp_dims)
    jcfg, tcfg = jcfgs.get(name), tcfgs.get(name)
    if not full:
        jcfg, tcfg = jcfgs.reduced(jcfg), tcfgs.reduced(tcfg)
    dims, glob = _jax_specs(jcfg, tp, fsdp=True)
    got = tp_dims(tcfg, tp)
    assert list(got) == list(dims)
    for leaf, want in dims.items():
        assert (got[leaf],) == tuple(want["model"] or [None]), leaf
        assert (param_dims(tcfg)[leaf],) == tuple(want["data"] or [None])
    assert [(n, s) for n, s, _ in param_layout(tcfg, tp)] == \
        list(glob.items())
    assert any(v is not None for v in got.values())
    model = Model(tcfg, ShardCtx(tp=tp, fsdp_axes=("data",)),
                  device="meta", fsdp_size=2)
    for (leaf, p), shape in zip(model.named_parameters(), glob.values()):
        want = list(shape)
        for ax, n in (("model", tp), ("data", 2)):
            for i in dims[leaf][ax]:
                want[i] //= n
        assert tuple(p.shape) == tuple(want), leaf


def test_kv_heads_replicate_past_tp():
    """At tp 16 the four kv heads of ``tinyllama-1.1b`` are replicated
    over ``model`` (``wk``/``wv`` have no TP dim), as are the norms."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.model import tp_dims
    dims = tp_dims(tcfgs.get("tinyllama-1.1b"), 16)
    assert dims["blocks.attn.wk.w"] is None is dims["blocks.attn.wv.w"]
    assert dims["blocks.attn.wq.w"] == 2 and dims["embed.table"] == 0
    assert tp_dims(tcfgs.get("tinyllama-1.1b"), 4)["blocks.attn.wk.w"] == 2


@pytest.mark.parametrize("name, tp, fsdp", [("tinyllama-1.1b", 2, 1),
                                            ("tinyllama-1.1b", 4, 2),
                                            ("qwen2-moe-a2.7b", 2, 2),
                                            ("arctic-480b", 2, 1),
                                            ("seamless-m4t-medium", 2, 2),
                                            ("seamless-m4t-medium", 4, 1),
                                            ("qwen2-vl-7b", 2, 1),
                                            ("qwen2-vl-7b", 4, 2),
                                            ("zamba2-2.7b", 2, 2),
                                            ("zamba2-2.7b", 4, 1),
                                            ("xlstm-350m", 2, 2),
                                            ("xlstm-350m", 8, 1)])
def test_load_slices_and_concatenation_round_trip(monkeypatch, name, tp,
                                                  fsdp):
    """``convert.load_params`` keeps each rank's slice of the JAX global
    parameters along the leaf's TP dim (at its ``model`` index) and FSDP
    dim (at its ``data`` index); the slices of every rank concatenated
    back give the global arrays bit for bit."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import base as tcfgs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.layers import ShardCtx, fsdp_dim
    from repro_torch.models.model import Model, param_layout
    from repro_torch.parallel import collectives as coll
    cfg = tcfgs.reduced(tcfgs.get(name))
    rng = np.random.default_rng(5)
    flat = {n: rng.standard_normal(s).astype(np.float32)
            for n, s, _ in param_layout(cfg, tp)}
    tree = {}
    for path, v in flat.items():
        *head, last = path.split(".")
        d = tree
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    axes = ("data",) if fsdp > 1 else ()
    got = {}
    for f in range(fsdp):
        for m in range(tp):
            monkeypatch.setattr(coll, "tp_index", lambda m=m: m)
            monkeypatch.setattr(mesh_mod, "rank", lambda a, f=f: f)
            model = Model(cfg, ShardCtx(tp=tp, fsdp_axes=axes,
                                        param_dtype=torch.float32),
                          device="cpu", fsdp_size=fsdp)
            convert.load_params(model, tree)
            got[f, m] = {n: p.detach().numpy().copy()
                         for n, p in model.named_parameters()}
    for n, want in flat.items():
        tdim = model.tp_dims[n]
        fdim = fsdp_dim(n)
        rows = []
        for f in range(fsdp):
            parts = [got[f, m][n] for m in range(tp)]
            rows.append(np.concatenate(parts, tdim) if tdim is not None
                        else parts[0])
            if tdim is None:
                assert all(np.array_equal(x, parts[0]) for x in parts)
        back = rows[0] if fsdp == 1 or fdim is None \
            else np.concatenate(rows, fdim % want.ndim)
        np.testing.assert_array_equal(back, want, err_msg=n)


def test_mesh_coords_follow_jax_device_order():
    """World rank ``r`` of a ``pod x data x model`` mesh sits where JAX's
    ``devices.reshape(procs, local, tp)`` puts device ``r``; every set of
    axes' groups partition the world into ranks that differ only along
    those axes."""
    from repro_torch.launch import mesh as mesh_mod
    procs, local, tp = 2, 3, 2
    grid = np.arange(procs * local * tp).reshape(procs, local, tp)
    for r in range(grid.size):
        at = mesh_mod._coords_of(r, local, tp)
        assert grid[at["pod"], at["data"], at["model"]] == r
    assert mesh_mod._axis_sets(1) == [("data",), ("pod",)]
    assert mesh_mod._axis_sets(2) == [("data",), ("pod",), ("model",),
                                      ("data", "model"), ("pod", "data")]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sp", [False, True])
def test_sp_slices_take_the_global_sinusoids(monkeypatch, tp, sp):
    """The reduced ``seamless-m4t-medium`` at ``tp`` on every model rank:
    ``stage_encoder_in`` and the decoder's ``stage_embed`` add the
    sinusoids of the global positions of the rank's slice of the sequence
    under SP (JAX ``sinusoidal_positions`` over the whole sequence, sliced
    as ``sp_scatter_embeds`` slices), the whole sequence's without SP;
    ``sp_scatter_embeds`` keeps the same slice of any input."""
    import jax.numpy as jnp
    import torch

    from repro.models.layers import sinusoidal_positions
    from repro_torch.configs import base as tcfgs
    from repro_torch.models import layers as tl
    from repro_torch.models.model import Model
    from repro_torch.parallel import collectives as coll
    cfg = tcfgs.reduced(tcfgs.get("seamless-m4t-medium"))
    b, s, d = 2, 24, cfg.d_model
    pe = np.asarray(sinusoidal_positions(jnp.arange(s), d))
    frames = torch.randn(b, s, d, generator=torch.Generator().manual_seed(1))
    tokens = torch.arange(b * s).reshape(b, s) % cfg.vocab
    n = s // tp if sp else s
    for m in range(tp):
        monkeypatch.setattr(coll, "tp_index", lambda m=m: m)
        ctx = tl.ShardCtx(compute_dtype=torch.float32, tp=tp,
                          seq_parallel=sp)
        model = Model(cfg, ctx, device="cpu")
        lo = m * n if sp else 0
        want = pe[lo:lo + n]
        got = model.stage_encoder_in(frames)
        np.testing.assert_allclose(got.numpy(), frames[:, lo:lo + n].numpy()
                                   + want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tl.sp_scatter_embeds(frames, ctx),
                                      frames[:, lo:lo + n])
        # the token lookup at tp > 1 sums over model: its positions only
        monkeypatch.setattr(
            "repro_torch.models.model.embedding_lookup",
            lambda table, ids, ctx, vocab: torch.zeros(
                b, n, d, dtype=ctx.compute_dtype))
        dec = model.stage_embed(model.embed.table, tokens)
        np.testing.assert_allclose(dec.detach().numpy(),
                                   np.broadcast_to(want, (b, n, d)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", OTHER)
def test_other_families_refuse_tp(name):
    """The hybrid and ssm families refuse only a ``tp`` their recurrent
    heads do not split over (``ValueError``: 16 SSD heads over 3 or 32
    ranks, 4 mLSTM heads over 3 or 6); they
    build at ``tp`` 2, 4 and (the mLSTM v-parts) 8, with SP and without,
    each leaf at its local shape, and ``train_step``'s check passes
    them."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model, local_shape, param_layout
    from repro_torch.train import train_step as tts
    cfg = tcfgs.reduced(tcfgs.get(name))
    tts._check_ported(cfg, cfg.plan)
    for tp in (3, 6) if cfg.family == "ssm" else (3, 32):
        with pytest.raises(ValueError):
            Model(cfg, ShardCtx(tp=tp), device="meta")
    for tp in (2, 4, 8) if cfg.family == "ssm" else (2, 4):
        for sp in (False, True):
            model = Model(cfg, ShardCtx(tp=tp, seq_parallel=sp),
                          device="meta")
            for (leaf, shape, _), (_, p) in zip(param_layout(cfg, tp),
                                                model.named_parameters()):
                assert tuple(p.shape) == local_shape(
                    leaf, shape, 1, tp, model.tp_dims[leaf]), leaf


@pytest.mark.parametrize("name", AUDIO_VLM)
def test_audio_and_vlm_build_at_tp(name):
    """``Model`` builds the reduced arch at ``tp`` 2 and 4, with SP and
    without, each leaf at its local shape, and ``train_step``'s check
    passes them."""
    from repro_torch.configs import base as tcfgs
    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model, local_shape, param_layout
    from repro_torch.train import train_step as tts
    cfg = tcfgs.reduced(tcfgs.get(name))
    tts._check_ported(cfg, cfg.plan)
    for tp in (2, 4):
        for sp in (False, True):
            model = Model(cfg, ShardCtx(tp=tp, seq_parallel=sp),
                          device="meta")
            for (leaf, shape, _), (_, p) in zip(param_layout(cfg, tp),
                                                model.named_parameters()):
                assert tuple(p.shape) == local_shape(
                    leaf, shape, 1, tp, model.tp_dims[leaf]), leaf


@pytest.mark.parametrize("name", AUDIO_VLM)
def test_frontend_inputs_are_drawn_for_the_global_batch(name):
    """``launch.inputs.with_frontend_inputs`` draws the stubbed frontend's
    fp32 ``(B, S, d_model)`` input of a global batch from its seed (the
    audio ``enc_embeds``; the vlm ``embeds`` and M-RoPE positions), so the
    rows each DP rank takes of it (``split_batch``, as the pod worker
    does) are the same at every mesh, and concatenate to the draw."""
    import torch

    from repro_torch.configs import base as tcfgs
    from repro_torch.data.synthetic import DataConfig, batch_at
    from repro_torch.launch.inputs import with_frontend_inputs
    from repro_torch.train import train_step as tts
    cfg = tcfgs.reduced(tcfgs.get(name))
    glob = with_frontend_inputs(cfg, batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=4), 0), 0)
    key = "enc_embeds" if cfg.family == "audio" else "embeds"
    want = torch.randn(4, 16, cfg.d_model,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(glob[key], want)
    if cfg.family == "vlm":
        assert tuple(glob["mrope_positions"].shape) == (3, 4, 16)
    for n in (1, 2, 4):
        parts = [tts.split_batch(glob, n, i) for i in range(n)]
        assert torch.equal(torch.cat([p[key] for p in parts]), want)
        if cfg.family == "vlm":
            assert torch.equal(torch.cat([p["mrope_positions"]
                                          for p in parts], 1),
                               glob["mrope_positions"])


def _int_view(t):
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _change(t, kind: str):
    """A copy of ``t`` (1-D) with one kind of change: two elements a
    multiple of 65521 positions apart swapped (``swapN``), +1 and -1 on
    two elements' bit patterns (``cancelling``), or ``0.0`` made
    ``-0.0`` (``signed zero``)."""
    out = t.clone()
    if kind.startswith("swap"):
        i, j = 7, 7 + 65521 * int(kind[len("swap"):])
        out[i], out[j] = t[j].clone(), t[i].clone()
    elif kind == "cancelling":
        bits = _int_view(out)
        bits[11] += 1
        bits[11 + 65521] -= 1
    else:
        out[3] = -0.0
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swap1", "swap2", "cancelling",
                                  "signed zero"])
def test_fingerprint_tells_swaps_and_cancelling_changes(dtype, kind):
    """``pod_worker.fingerprint`` (the card-side comparison of states in
    the TP cells and serial == overlap) gives equal bits equal prints,
    and another print to two elements swapped 65521 positions (or a
    multiple) apart, to bit deltas that cancel in the plain sum, and to
    ``-0.0`` in place of ``0.0``, where two sums weighted by the position
    mod 65521 could not tell the first two."""
    import torch

    from repro_torch.train.pod_worker import fingerprint
    g = torch.Generator().manual_seed(0)
    t = torch.randn(3 * 65521 + 5, generator=g).to(getattr(torch, dtype))
    t[3] = 0.0
    assert fingerprint(t) == fingerprint(t.clone())
    changed = _change(t, kind)
    assert not torch.equal(_int_view(changed), _int_view(t))
    assert fingerprint(changed) != fingerprint(t)
    if kind != "signed zero":
        # the plain sum alone cannot tell these
        assert fingerprint(changed)[0] == fingerprint(t)[0]
