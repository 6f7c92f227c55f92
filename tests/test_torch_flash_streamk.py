"""The port's streaming-K flash backward (B3) against the JAX package's.

- ``flash_bwd_streamk_plain``, reached through ``flash_attention_with_lse``'s
  autograd with the backward forced to ``"streamk"``, against ``jax.vjp``
  through the Pallas ``_bwd_streamk_kernel`` in interpret mode (forced
  the same way, as ``tests/test_flash_attention.py`` forces it), at
  B=2, T=64, H=2, D=16 with 16-key slots (4 dQ partials): float32 to
  2e-5, the JAX streaming-K test's own tolerance; bf16 to 2e-2 of each
  gradient's largest magnitude.
- The dispatch (merged or streaming-K) and the slot width against the
  JAX package's ``_merged_bwd_fits`` and ``_prep``.
- The plain streaming-K and merged backwards compute the same function.
- The slice on the CPU: a tiny ``longcontext_lm`` whose attention goes
  through the port's ``flash_attention`` with B3 forced takes three
  ``Trainer`` steps beside the JAX ``Trainer``.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import dataclasses
import importlib
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import edl_tpu_torch.models.transformer_lm as tlm
from edl_tpu.models import get_model as jax_get_model
from edl_tpu.models.transformer_lm import TransformerLM as FlaxLM
from edl_tpu.ops.losses import best_vocab_xent as jax_best_vocab_xent
from edl_tpu.parallel import dp_mesh
from edl_tpu.runtime import ShardedDataIterator as JaxIterator
from edl_tpu.runtime import Trainer as JaxTrainer
from edl_tpu.runtime.data import synthetic_dataset as jax_synthetic_dataset
from edl_tpu_torch.convert import params_from_flax
from edl_tpu_torch.models import get_model
from edl_tpu_torch.runtime import ShardedDataIterator, Trainer

jfa = importlib.import_module("edl_tpu.ops.flash_attention")
pfa = importlib.import_module("edl_tpu_torch.ops.flash_attention")

B, T, H, D, SLOT = 2, 64, 2, 16, 16
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(seed, t=T):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, t, H, D).astype(np.float32) for _ in range(4))
    g_lse = rng.randn(B, H, t).astype(np.float32)
    mask = rng.rand(B, t) > 0.3
    return q, k, v, do, g_lse, mask


def _jax_streamk_grads(q, k, v, do, g_lse, causal, mask, dtype):
    """dQ, dK, dV through the JAX package's streaming-K backward in
    interpret mode, 16x16 forward tiles, 16-key slots."""
    jd = getattr(jnp, dtype)

    def f(q, k, v):
        return jfa.flash_attention_with_lse(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            block_q=16, block_k=16, bwd_block_q=16, bwd_block_k=SLOT,
            interpret=True,
        )

    jfa._BWD_IMPL_OVERRIDE = "streamk"
    try:
        _, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
        grads = vjp((jnp.asarray(do, jd), jnp.asarray(g_lse, jnp.float32)))
    finally:
        jfa._BWD_IMPL_OVERRIDE = None
    return [np.asarray(g, np.float32) for g in grads]


@pytest.fixture
def port_streamk(monkeypatch):
    """The port's backward forced to streaming-K; records the slot
    width of every plain streaming-K backward it runs."""
    widths = []
    plain = pfa.flash_bwd_streamk_plain

    def recording(*args, **kwargs):
        widths.append(args[10])
        return plain(*args, **kwargs)

    monkeypatch.setattr(pfa, "_BWD_IMPL_OVERRIDE", "streamk")
    monkeypatch.setattr(pfa, "flash_bwd_streamk_plain", recording)
    return widths


@pytest.mark.parametrize(
    "causal,masked,with_glse,dtype",
    [
        (True, False, False, "float32"),
        (False, True, False, "float32"),
        (True, True, False, "float32"),
        (False, False, False, "float32"),
        (True, False, True, "float32"),
        (True, True, True, "bfloat16"),
    ],
    ids=["causal", "kv_mask", "causal-kv_mask", "neither", "lse-grad", "bf16"],
)
def test_streamk_matches_jax_streamk_kernel(port_streamk, causal, masked, with_glse, dtype):
    """The masked cases have a batch row with every key masked, whose
    gradients are exactly 0 on both sides."""
    q, k, v, do, g_lse, mask = _inputs(21)
    if not with_glse:
        g_lse = np.zeros_like(g_lse)
    if masked:
        mask[1] = False
    else:
        mask = None
    want = _jax_streamk_grads(q, k, v, do, g_lse, causal, mask, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = pfa.flash_attention_with_lse(tq, tk, tv, causal, None, tm, bwd_block_k=SLOT)
    outs, cots = [o], [torch.from_numpy(do).to(td)]
    if with_glse:
        outs.append(lse)
        cots.append(torch.from_numpy(g_lse))
    got = torch.autograd.grad(outs, (tq, tk, tv), cots)
    assert port_streamk == [SLOT]
    for g, w in zip(got, want):
        assert g.dtype == td
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        else:
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL * scale)
        if masked:
            assert np.all(g[1] == 0.0)


@pytest.mark.parametrize("t", [2048, 16384, 16385, 32768, 65536])
@pytest.mark.parametrize("d", [64, 128])
def test_dispatch_and_slot_width_follow_jax_prep(t, d):
    """Merged or streaming-K as the JAX package picks, and where it
    picks streaming-K, its slot width (``_prep``'s ``bwd_block_k``)."""
    fits = jfa._merged_bwd_fits(t, d)
    assert pfa.merged_bwd_fits(t, d) == fits
    assert pfa.bwd_impl(t, d) == ("merged" if fits else "streamk")
    if fits:
        return
    shape = SimpleNamespace(shape=(1, t, 1, d))
    prep = jfa._prep(shape, shape, True, None, None, None, None, None, None, True)
    assert prep[6] >= 512
    assert pfa.streamk_slot_width(t) == prep[6]


def test_slot_count_stays_bounded_at_a_prime_length():
    """T=16411 is prime: the JAX package's divisor pick gives 1-key
    slots (16411 partials); the port takes the wanted 2051 keys with a
    ragged last slot, 9 partials.  Caller-named widths are kept where
    they divide T and where a divisor of at least 512 keys exists."""
    t = 16411
    assert all(t % p for p in range(2, int(t ** 0.5) + 1))
    assert not pfa.merged_bwd_fits(t, 64)
    assert jfa._pick_block(t, max(2048, t // 8)) == 1
    width = pfa.streamk_slot_width(t)
    assert width == t // 8 == 2051 and -(-t // width) == 9
    assert pfa.streamk_slot_width(64, 16) == 16
    assert pfa.streamk_slot_width(3000, 700) == jfa._pick_block(3000, 700) == 600
    assert pfa.streamk_slot_width(3001, 700) == 700  # 3001 has no divisor in [512, 700]
    assert pfa.streamk_slot_width(300) == 300
    with pytest.raises(ValueError, match="positive"):
        pfa.flash_attention(torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16),
                            torch.zeros(1, 8, 1, 16), bwd_block_k=0)


@pytest.mark.parametrize(
    "causal,masked,t,slot",
    [(True, False, 64, 16), (False, True, 50, 16), (True, True, 64, 7), (True, False, 130, 64)],
    ids=["causal", "kv_mask-ragged-T", "ragged-slot", "one-tile-slots"],
)
def test_plain_streamk_equals_plain_merged(causal, masked, t, slot):
    """The same function up to float32 grouping (the dQ partials are
    summed per slot), with the lse cotangent, and head by head equal to
    all heads at once."""
    q, k, v, do, g_lse, mask = (torch.from_numpy(x) for x in _inputs(22, t))
    if masked:
        mask[1] = False
    else:
        mask = None
    o, lse = pfa.flash_attention_plain(q, k, v, causal, None, mask)
    args = (q, k, v, o, lse, do, g_lse, mask, causal, D ** -0.5)
    merged = pfa.flash_bwd_plain(*args)
    streamk = pfa.flash_bwd_streamk_plain(*args, slot)
    by_head = pfa.flash_bwd_streamk_plain(*args, slot, by_head=True)
    for m, s, h in zip(merged, streamk, by_head):
        torch.testing.assert_close(s, m, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, s, rtol=1e-6, atol=1e-6)


# -- the slice on the CPU: tiny longcontext_lm, B3 forced ------------------

V, DM, FF, HEADS, LAYERS, L = 256, 64, 256, 4, 2, 64
LR, STEPS = 1e-3, 3


def _jax_model():
    """The registered JAX tiny ``longcontext_lm`` at T=64 in float32
    compute, with the reference's own ``loss_fn`` body."""
    base = jax_get_model("longcontext_lm", tiny=True, seq_len=L)
    module = FlaxLM(V, DM, FF, HEADS, LAYERS, L, dtype=jnp.float32)

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x = module.apply({"params": params}, tokens[:, :-1], return_features=True)
        loss, _ = jax_best_vocab_xent(x, params["embed"]["embedding"], labels, labels != 0)
        return loss, {"loss": loss}

    return dataclasses.replace(base, loss_fn=loss_fn)


def test_longcontext_slice_trains_like_jax_with_streamk_forced(port_streamk, monkeypatch):
    """Three Adam steps of the port's ``Trainer`` on the tiny
    ``longcontext_lm`` (attention through ``flash_attention`` with
    16-key slots, the backward forced to streaming-K: one plain B3 per
    layer per step) against the JAX ``Trainer`` on the same converted
    weights and batches: the loss stream to 1e-4, as
    ``tests/test_torch_train.py`` holds it."""

    def attention(q, k, v, causal=False, scale=None, kv_mask=None):
        return pfa.flash_attention(q, k, v, causal, scale, kv_mask, bwd_block_k=SLOT)

    monkeypatch.setattr(tlm, "fused_attention", attention)
    jm = _jax_model()
    init = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.key(0)))
    ds = jax_synthetic_dataset(jm.synth_batch, 32, seed=0)

    mesh = dp_mesh(1, jax.devices("cpu")[:1])
    jtrainer = JaxTrainer(jm, optax.adam(LR), mesh, seed=0)
    jstate = jtrainer.init_state()
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, init))
    jstate = jstate.replace(opt_state=optax.adam(LR).init(jstate.params))
    jit = JaxIterator(ds, 4, seed=0)
    want = []
    for step in range(STEPS):
        jstate, metrics = jtrainer.step(jstate, jit.device_batch(step, mesh))
        want.append(float(metrics["loss"]))

    model = get_model("longcontext_lm", tiny=True, seq_len=L, dtype=torch.float32)
    assert model.name == "longcontext_lm" and model.tokens_per_example == L
    trainer = Trainer(model, lr=LR, device="cpu", seed=0)
    state = trainer.init_state(params_from_flax(init))
    it = ShardedDataIterator(ds, 4, seed=0)
    got = []
    for step in range(STEPS):
        state, metrics = trainer.step(state, it.device_batch(step, "cpu"))
        got.append(metrics["loss"].item())
    assert port_streamk == [SLOT] * (LAYERS * STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_training_profile_classes_b3_apart_from_b2():
    """``profile_training`` files each backward's kernels under its own
    item, the delta passes included (each library names its own)."""
    from edl_tpu_torch.tools.profile_training import _kernel_class

    b3 = ("void (anonymous namespace)::flash_bwd_streamk_kernel<__nv_bfloat16, 64>"
          "((anonymous namespace)::StreamkArgs)",
          "void (anonymous namespace)::flash_bwd_streamk_reduce_kernel<__nv_bfloat16, 64>"
          "((anonymous namespace)::StreamkArgs, int)",
          "void (anonymous namespace)::flash_bwd_streamk_delta_kernel<__nv_bfloat16, 64>"
          "(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, int, int, int)")
    b2 = ("void (anonymous namespace)::flash_bwd_dkdv_kernel<__nv_bfloat16, 64>"
          "((anonymous namespace)::Args)",
          "void (anonymous namespace)::flash_bwd_delta_kernel<__nv_bfloat16, 64>"
          "(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, int, int, int)")
    assert {_kernel_class(n) for n in b3} == {"flash_bwd_streamk (B3)"}
    assert {_kernel_class(n) for n in b2} == {"flash_bwd (B2)"}
    assert _kernel_class("void (anonymous namespace)::flash_fwd_kernel<__half, 128>(...)") \
        == "flash_fwd (B1)"
    assert _kernel_class("void (anonymous namespace)::xent_dy_kernel<768>(...)") == "xent_dy (B5)"


def test_longcontext_model_at_full_length_matches_the_reference():
    """The full-width ``longcontext_lm`` at T=32768, as the chip runs it:
    the JAX package's FLOP count (8.09e13 per example) and tokens, and
    the synthetic corpus at L=32768 byte for byte (nothing is built)."""
    from edl_tpu_torch.runtime import synthetic_dataset

    model = get_model("longcontext_lm", seq_len=32768)
    jm = jax_get_model("longcontext_lm", seq_len=32768)
    assert model.tokens_per_example == jm.tokens_per_example == 32768
    assert model.flops_per_example == jm.flops_per_example
    assert round(model.flops_per_example / 1e13, 2) == 8.09
    a = synthetic_dataset(model.synth_batch, 2, seed=0)["tokens"]
    b = jax_synthetic_dataset(jm.synth_batch, 2, seed=0)["tokens"]
    assert a.shape == (2, 32769) and a.tobytes() == b.tobytes()


def test_kernel_library_names_hash_only_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A header edit renames (so rebuilds) only the libraries whose
    source includes it, directly or through another header."""
    from edl_tpu_torch.ops import _build

    (tmp_path / "tiles.cuh").write_text("// tiles v1\n")
    (tmp_path / "outer.cuh").write_text('#include "tiles.cuh"\n')
    (tmp_path / "alone.cu").write_text("#include <cuda_runtime.h>\n")
    (tmp_path / "direct.cu").write_text('#include "tiles.cuh"\n')
    (tmp_path / "nested.cu").write_text('  #  include "outer.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("alone", "direct", "nested")
    before = {n: _build.library_path(n) for n in names}
    (tmp_path / "tiles.cuh").write_text("// tiles v2\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["alone"] == before["alone"]
    assert after["direct"] != before["direct"]
    assert after["nested"] != before["nested"]

    # the repo's own sources: the Hopper header (TMA, mbarrier, wgmma)
    # reaches every kernel, B1-B6
    csrc = tmp_path / "csrc"
    shutil.copytree(Path(pfa.__file__).parent / "csrc", csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if after[n] != before[n]} == {
        "flash_fwd", "flash_bwd", "flash_bwd_streamk", "xent_fwd", "xent_dy", "xent_de"}
    # and the delta pass's header reaches both backwards and nothing else
    with open(csrc / "flash_bwd_delta.cuh", "a") as f:
        f.write("// edited\n")
    again = {n: _build.library_path(n) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if again[n] != after[n]} == {
        "flash_bwd", "flash_bwd_streamk"}


@pytest.mark.parametrize("name", [
    "flash_fwd.cu", "flash_bwd.cu", "flash_bwd_streamk.cu", "xent_fwd.cu", "xent_dy.cu",
    "xent_de.cu"])
def test_redesigned_kernels_are_wgmma_and_tma_only(name):
    """B1-B6 are built from wgmma and TMA (``hopper.cuh``); no WMMA tile
    and no old tile header is left in their sources, and none uses float
    atomics.  Every product but B4's (one product with a row-statistics
    epilogue, both operands in shared memory) takes a register operand."""
    csrc = Path(pfa.__file__).parent / "csrc"
    text = (csrc / name).read_text()
    assert '#include "hopper.cuh"' in text
    assert "wmma::" not in text and "<mma.h>" not in text
    assert "flash_bwd_tiles.cuh" not in text
    assert "atomicAdd" not in text and "red.global" not in text
    assert "wgmma_ss<" in text and "tma_load_4d(" in text
    assert ("wgmma_rs<" in text) == (name != "xent_fwd.cu")
    assert not (csrc / "fused_xent.cu").exists()
    header = (csrc / "hopper.cuh").read_text()
    assert "cudaGetDriverEntryPoint" in header and "cp.async.bulk.tensor.4d" in header


def _streamk_dq_partial_traffic(geo, t, slot_w, d, causal):
    """The live (128-key tile, 64-row Q tile) pairs of a square
    streaming-K launch for one batch*head, and the bytes of dQ partial
    rows they move: each reads and writes 64 x D f32 rows, the first key
    tile of a slot only writes them."""
    rows = geo["chunk_rows"]
    pairs = writes_only = 0
    for c in range(geo["n_chunks"]):
        q_first, q_end = c * rows // 64, -(-min((c + 1) * rows, t) // 64)
        for j in range(geo["n_slots"]):
            if causal and j * slot_w > min((c + 1) * rows, t) - 1:
                continue
            for k0 in range(j * slot_w, min((j + 1) * slot_w, t), 128):
                n = max(0, q_end - (max(q_first, k0 // 64) if causal else q_first))
                pairs += n
                writes_only += n if k0 == j * slot_w else 0
    return pairs, (2 * pairs - writes_only) * 64 * d * 4


def test_streamk_geometry_at_the_long_context_shape():
    """The B3 wrapper's host-side geometry at [1, 32768, 12, 64] causal
    with the default 4096-key slots: the numbers the kernel's source note
    states (blocks, workspace, live tile pairs and their dQ partial
    traffic)."""
    assert pfa.streamk_slot_width(32768) == 4096
    geo = pfa.streamk_geometry(1, 12, 32768, 32768, 64, 4096, True)
    assert geo == {
        "chunk_rows": 4096, "n_slots": 8, "n_chunks": 8, "tq_pad": 32768,
        "live_pairs": 36, "blocks": 432,
        "dq_partial_bytes": 805_306_368, "dkv_partial_bytes": 1_610_612_736,
        "delta_bytes": 1_572_864,
    }
    # the workspace stays under the first version's 4.03 GB
    assert geo["dq_partial_bytes"] + geo["dkv_partial_bytes"] + geo["delta_bytes"] < 4.03e9
    pairs, traffic = _streamk_dq_partial_traffic(geo, 32768, 4096, 64, True)
    assert 12 * pairs == 789_504 and 12 * traffic == 25_417_482_240


@pytest.mark.parametrize("t,slot,causal", [(300, 100, False), (300, 100, True), (130, 48, True)])
def test_streamk_geometry_counts_the_live_blocks(t, slot, causal):
    """Live (slot, Q chunk) blocks and workspace against a brute-force
    walk of every (query row, key) pair: a block is live when one of its
    rows may attend one of its keys."""
    geo = pfa.streamk_geometry(2, 3, t, t, 16, slot, causal)
    rows = geo["chunk_rows"]
    live = sum(
        any(not causal or k <= q
            for q in range(c * rows, min((c + 1) * rows, t))
            for k in range(j * slot, min((j + 1) * slot, t)))
        for c in range(geo["n_chunks"]) for j in range(geo["n_slots"]))
    assert geo["n_slots"] * slot >= t > (geo["n_slots"] - 1) * slot
    assert geo["n_chunks"] * rows >= t > (geo["n_chunks"] - 1) * rows
    assert geo["live_pairs"] == live and geo["blocks"] == 6 * live
    assert geo["dq_partial_bytes"] == 6 * geo["n_slots"] * geo["tq_pad"] * 16 * 4
    assert geo["dkv_partial_bytes"] == 2 * 6 * geo["n_chunks"] * t * 16 * 4
    assert geo["delta_bytes"] == 6 * t * 4


def test_chip_smoke_row_check_follows_each_rows_scale():
    """``chip_smoke.py``'s row check, on the CPU: a bf16 rounding of
    every value passes; zeroing the rows of a late, small-valued half
    fails it although it stays under 2e-2 of the tensor's largest value;
    rows under the floor are held against the floor."""
    import chip_smoke

    rng = np.random.RandomState(0)
    t = 32768
    # causal-attention-like rows at the long-context length: magnitude
    # ~ 1/sqrt(t)
    want = torch.from_numpy(rng.randn(1, t, 1, 64).astype(np.float32))
    want *= torch.arange(1, t + 1, dtype=torch.float32).rsqrt()[None, :, None, None]
    rounded = want.to(torch.bfloat16)
    assert chip_smoke._row_err(rounded, want) < 4e-3
    late = rounded.clone()
    late[:, t // 2:] = 0
    assert chip_smoke._rel_err(late, want) < chip_smoke.GRAD_TOL
    assert chip_smoke._row_err(late, want) == pytest.approx(1.0)
    tiny = want.clone()
    tiny[:, 0] = 1e-9
    noisy = tiny.clone()
    noisy[:, 0] = -1e-9
    assert chip_smoke._row_err(noisy, tiny) < 1e-3
