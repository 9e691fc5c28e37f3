"""Multi-device parity of the PyTorch port (parallel/mesh.py) on the CPU: two
gloo ranks, micro_dual_config with 8 views (4 a rank), against the port in
one process and against the JAX package on one device.

One module-scoped spawn (imagine360_tpu_torch.entry.dryrun_multidevice)
runs every sharded case in the two ranks and the same cases in this
process; the JAX references (the 2-step denoise and one train step) run
here while the ranks work. Weights and inputs come from numpy and the JAX
package's keys (the set-up of tests/test_torch_dual.py and
tests/test_torch_training.py) and reach the ranks as tensors.

Tolerances (float32; the ranks sum in another order than one process):
- the denoise latents, SAM, the VAE: atol 2e-5, rtol 1e-4, as
  tests/test_mesh_parity.py holds the JAX package's sharded denoise;
- the train step against one process: loss rtol 2e-5 and the weights after
  one AdamW step within 5e-6, as tests/test_training.py holds its sharded
  step, on every element but those whose one-process gradient is at
  rounding level (under 1e-6 of the largest and not zero on both sides:
  every bias ahead of a GroupNorm with one channel per group), where AdamW
  turns the rounding's sign into a step of +-lr (tests/test_torch_training.py
  has the same rule); the all-reduced gradients within 1e-5 of the largest;
- the train step against JAX: loss rtol 1e-5, gradients 1e-4 of the
  largest, as tests/test_torch_training.py holds one process.

Under the two ranks the pano's latent rows are sharded (stage heights 8 / 4
divide 2): the denoise, train and EMA cases above run the halo convs, the
merged GroupNorm statistics and the gathered keys. Beside them, in the same
spawn: a pano of 6 latent rows (stage heights 6 / 3) that stays replicated
and equals one process to the same tolerance; the halo conv (also at stride
2 and after the upsample), the merged GroupNorm and the row gather each
alone, forward and gradients equal to the whole tensor's to 1e-5 of their
largest; and each rank's pano activations and attention queries holding
1/2 of the rows.

Also: the per-shard attention shapes of full_dual_config at every world
size 20 views divide over take the same kernel route on CUDA as the whole
shapes (fault F3), with and without grad, the pano rows at the worlds whose
rows shard included; the bias rows each rank keeps; the rule that picks
those worlds; shard_frames and shard_batch; a layout the views or the
replicas do not divide raises.
"""
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                             build_dual_warp_geoms)
from imagine360_tpu.presets import micro_dual_config
from imagine360_tpu.training.train import (TrainConfig, TrainState, make_dual_batch,
                                           make_train_step)
from imagine360_tpu.utils.convert import unflatten

from imagine360_tpu_torch import entry
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.ops.dispatch import select_attention_route
from imagine360_tpu_torch.parallel import mesh as tmesh
from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms as t_build_geoms
from imagine360_tpu_torch.presets import tiny_dual_config
from imagine360_tpu_torch.utils.convert import from_jax_params, from_jax_tree

from test_torch_dispatch import CUDA_SITES
from test_torch_dual import random_params
from test_torch_training import _capture_grads, _jax_draws

N_RANKS = 2
M, F = entry.DRYRUN_VIEWS, entry.DRYRUN_FRAMES
PERS_HW, PANO_HW = entry.DRYRUN_PERS_HW, entry.DRYRUN_PANO_HW
TRAIN_KW = dict(lr=1e-4, weight_decay=1e-2, antipodal_prob=0.5)
RANKS = list(range(N_RANKS))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _in_thread(fn):
    """Start fn() in a thread; the returned callable joins it and returns
    its value or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the joining thread
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "error" in box:
            raise box["error"]
        return box["value"]
    return join


def _jax_inputs():
    """The JAX model, its random weights (flat, numpy), the denoise inputs,
    the train batch and the geometry."""
    cfg = micro_dual_config(num_views=M)
    model = DualUNet(cfg)
    geoms = build_dual_warp_geoms(cfg, CameraRig.icosahedron(image_size=8 * PERS_HW[0]).take(M),
                                  PERS_HW, PANO_HW, bias_dtype=np.float32)
    batch = make_dual_batch(jax.random.PRNGKey(0), cfg, F, PERS_HW, PANO_HW,
                            text_len=entry.DRYRUN_TEXT_LEN, sam_tokens=entry.DRYRUN_SAM_TOKENS,
                            sam_frames=entry.DRYRUN_SAM_FRAMES)
    rng = np.random.default_rng(21)
    for k in ("pers_mask", "pano_mask"):       # every input channel counts
        batch[k] = jnp.asarray((rng.random(batch[k].shape) > 0.5).astype(np.float32))
    for k in ("pers_masked", "pano_masked"):
        batch[k] = jnp.asarray(rng.standard_normal(batch[k].shape).astype(np.float32))
    pers_in = jnp.concatenate([batch["pers_latents"], batch["pers_mask"],
                               batch["pers_masked"]], axis=-1)
    pano_in = jnp.concatenate([batch["pano_latents"], batch["pano_mask"],
                               batch["pano_masked"]], axis=-1)
    flat = random_params(model, (pers_in, pano_in, jnp.zeros((1,)), batch["pers_text"],
                                 batch["pano_text"], batch["fps"], batch["ref_feats_pers"],
                                 batch["ref_feats_pano"], batch["rel_pos"], batch["pitch"],
                                 geoms, jnp.zeros((3,), bool)), seed=22)
    (ph, pw), (eh, ew) = PERS_HW, PANO_HW
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)    # noqa: E731
    hid, ctx = cfg.pers.image_hidden_size, cfg.pers.cross_attention_dim
    sam_f, sam_t, L = entry.DRYRUN_SAM_FRAMES, entry.DRYRUN_SAM_TOKENS, entry.DRYRUN_TEXT_LEN
    den = dict(pano=f32(1, F, eh, ew, 4), pers=f32(1, M, F, ph, pw, 4),
               pano_mask=(rng.random((1, F, eh, ew, 1)) > 0.5).astype(np.float32),
               pano_masked=f32(1, F, eh, ew, 4),
               pers_mask=(rng.random((1, M, F, ph, pw, 1)) > 0.5).astype(np.float32),
               pers_masked=f32(1, M, F, ph, pw, 4), pano_text=f32(2, L, ctx),
               pers_text=f32(2 * M, L, ctx), ref_pano=f32(2, sam_f, sam_t, hid),
               ref_pers=f32(2 * M, sam_f, sam_t, hid),
               rel=rng.integers(0, 50, (2, F, 6)).astype(np.float32),
               pitch=rng.integers(0, 90, (2, F)).astype(np.float32),
               fps=np.full((2,), 8.0, np.float32))
    return model, {"params": unflatten({k: jnp.asarray(v) for k, v in flat.items()})}, flat, \
        den, batch, geoms


def _jax_denoise(model, params, den, geoms):
    j = jnp.asarray
    sampler = DualDiffusionSampler(model, SamplerConfig(num_steps=entry.DRYRUN_STEPS,
                                                        add_ip_noise=False,
                                                        antipodal_prob=0.0))
    ip_pers, ip_pano = sampler.compute_ip(params, j(den["ref_pers"]), j(den["ref_pano"]),
                                          j(den["rel"]), j(den["pitch"]))
    pano, pers = sampler.denoise(
        params, jax.random.PRNGKey(0), j(den["pano"]), j(den["pers"]), j(den["pano_mask"]),
        j(den["pano_masked"]), j(den["pers_mask"]), j(den["pers_masked"]),
        j(den["pano_text"]), j(den["pers_text"]), geoms, j(den["fps"]),
        rel_pos=j(den["rel"]), pitch=j(den["pitch"]), ip_tokens_pers=ip_pers,
        ip_tokens_pano=ip_pano)
    return np.asarray(pano), np.asarray(pers)


def _jax_train(model, params, batch, geoms, key):
    """The JAX train step's loss and gradients (its optimizer only keeps the
    gradients: the weights after a step are held against one process of the
    port). Compiled without LLVM's optimisations, the same program in about
    a third less time; loss and gradients agree with the default compile to
    within 1e-6 of their size."""
    tx = _capture_grads()
    train_step, _ = make_train_step(model, geoms, optimizer=tx,
                                    train_cfg=TrainConfig(**TRAIN_KW))
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(train_step).lower(state, batch, key).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    state, metrics = step(state, batch, key)
    return float(metrics["loss"]), from_jax_tree(state.opt_state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the dry run's results, the JAX references): the ranks, the JAX train
    step and the JAX denoise run side by side."""
    model, params, flat, den, batch, geoms = _jax_inputs()
    key = jax.random.PRNGKey(5)
    train = _in_thread(lambda: _jax_train(model, params, batch, geoms, key))
    draws = _jax_draws(model, params, key, batch, 3, TRAIN_KW["antipodal_prob"])
    T = torch.from_numpy
    inputs = dict(
        state_dict=from_jax_params(flat),
        denoise={k: T(v) for k, v in den.items()},
        train_batch={k: T(np.array(v)) for k, v in batch.items()},
        train_draws=dict(t=T(draws["t"]), noise_pers=T(draws["noise_pers"]),
                         noise_pano=T(draws["noise_pano"]), use_opp=draws["use_opp"],
                         ip_noise=tuple(T(x) for x in draws["ip_noise"])))
    out_dir = str(tmp_path_factory.mktemp("dryrun"))
    dry = _in_thread(lambda: entry.dryrun_multidevice(N_RANKS, inputs, out_dir))
    jax_denoise = _jax_denoise(model, params, den, geoms)
    return dry(), {"denoise": jax_denoise, "train": train()}


def _allclose(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("rank", RANKS)
def test_each_rank_has_its_layout(runs, rank):
    got = runs[0]["ranks"][rank]["mesh"]
    assert got == dict(r1=(N_RANKS, rank, 1, N_RANKS), r2=(N_RANKS, rank, 2, N_RANKS // 2),
                       backend="gloo")


@pytest.mark.parametrize("case", ["denoise", "denoise_r2", "denoise_draws"])
@pytest.mark.parametrize("rank", RANKS)
def test_sharded_denoise_matches_one_process(runs, case, rank):
    got, want = runs[0]["ranks"][rank][case], runs[0]["single"][case]
    assert got[0].shape == (1, F, *PANO_HW, 4) and got[1].shape == (1, M, F, *PERS_HW, 4)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    for g, w in zip(got, want):
        _allclose(g, w)


@pytest.mark.parametrize("rank", RANKS)
def test_a_pano_whose_stage_heights_do_not_divide_stays_replicated(runs, rank):
    got, want = runs[0]["ranks"][rank], runs[0]["single"]
    assert got["pano_layout"]["denoise_replicated"].startswith("pano replicated")
    for case in ("denoise", "denoise_r2", "denoise_draws"):
        assert got["pano_layout"][case].startswith(f"pano rows sharded over {N_RANKS} ranks")
    rows = entry.DRYRUN_REPLICATED_PANO_ROWS
    assert got["denoise_replicated"][0].shape == (1, F, rows, PANO_HW[1], 4)
    for g, w in zip(got["denoise_replicated"], want["denoise_replicated"]):
        _allclose(g, w)


@pytest.mark.parametrize("unit", ["conv", "down", "up", "norm", "gather"])
@pytest.mark.parametrize("rank", RANKS)
def test_a_row_unit_matches_the_whole_tensor(runs, unit, rank):
    """Forward, input gradient (gathered) and parameter gradients (summed
    over the ranks) of one pano-row piece against the whole tensor's."""
    got, want = runs[0]["ranks"][rank]["row_units"][unit], runs[0]["single"]["row_units"][unit]
    pairs = [(got["out"], want["out"]), (got["grad"], want["grad"])]
    assert got["params"].keys() == want["params"].keys()
    pairs += [(got["params"][n], w) for n, w in want["params"].items()]
    for g, w in pairs:
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("rank", RANKS)
def test_each_rank_holds_its_share_of_the_pano_rows(runs, rank):
    """Every GroupNorm of the pano branch sees H / 2 latent rows on a rank,
    and every attention call of the forward (spatial, cross, WarpAttn and
    the frame attention of both branches) takes half the query rows with
    all the keys: no branch is left replicated."""
    got, want = runs[0]["ranks"][rank]["shapes"], runs[0]["single"]["shapes"]
    assert len(got["pano_rows"]) == len(want["pano_rows"]) > 0
    assert [n * N_RANKS for n in got["pano_rows"]] == want["pano_rows"]
    assert len(got["attention"]) == len(want["attention"]) > 0
    n_pano_s0 = 0
    for (B, Sq, Sk, H, D), (B1, Sq1, Sk1, H1, D1) in zip(got["attention"], want["attention"]):
        assert B * Sq * N_RANKS == B1 * Sq1 and (Sk, H, D) == (Sk1, H1, D1)
        if Sq1 == Sk1 == PANO_HW[0] * PANO_HW[1]:     # the pano's stage-0 self-attention
            assert (B, Sq) == (B1, Sq1 // N_RANKS)
            n_pano_s0 += 1
    assert n_pano_s0 > 0


@pytest.mark.parametrize("case", ["denoise", "denoise_r2"])
@pytest.mark.parametrize("rank", RANKS)
def test_sharded_denoise_matches_jax(runs, case, rank):
    for g, w in zip(runs[0]["ranks"][rank][case], runs[1]["denoise"]):
        _allclose(g, w)


@pytest.mark.parametrize("case", ["train", "train_remat"])
@pytest.mark.parametrize("rank", RANKS)
def test_sharded_train_step_matches_one_process(runs, case, rank):
    """Under remat (`train_remat`) WarpAttn's gather runs again in the
    backward, on every rank in the same order."""
    got, want = runs[0]["ranks"][rank][case], runs[0]["single"][case]
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(), rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"].item(), rtol=2e-5)
    top = max(float(g.abs().max()) for g in want["grads"].values())
    n_exempt = n_all = 0
    for n, w in want["grads"].items():
        assert float((got["grads"][n] - w).abs().max()) <= 1e-5 * top, n
        exempt = (w.abs() < 1e-6 * top) & ((w != 0) | (got["grads"][n] != 0))
        d = (got["params"][n] - want["params"][n]).abs()
        assert float((d * ~exempt).max()) <= 5e-6, n
        assert float(d.max()) <= 2 * TRAIN_KW["lr"] * 1.01, n
        n_exempt, n_all = n_exempt + int(exempt.sum()), n_all + d.numel()
    assert n_exempt <= 0.03 * n_all, (n_exempt, n_all)


@pytest.mark.parametrize("rank", RANKS)
def test_sharded_train_step_matches_jax(runs, rank):
    got = runs[0]["ranks"][rank]["train"]
    loss, grads = runs[1]["train"]
    np.testing.assert_allclose(got["loss"].item(), loss, rtol=1e-5)
    assert got["grads"].keys() == grads.keys()
    top = max(float(g.abs().max()) for g in grads.values())
    for n, want in grads.items():
        assert float((got["grads"][n] - want).abs().max()) <= 1e-4 * top, n


@pytest.mark.parametrize("rank", RANKS)
def test_ema_and_accumulation_under_two_replicas(runs, rank):
    """mesh_replicas 2: the first call of an accumulation pair moves no
    weight, the second moves them all, the EMA lags them; the losses are
    the one process's."""
    got, want = runs[0]["ranks"][rank]["ema_accum"], runs[0]["single"]["ema_accum"]
    p0, p1, p2, ema = (got[k] for k in ("params_0", "params_1", "params_2", "ema"))
    assert all(torch.equal(p1[n], p0[n]) for n in p0)
    for n in p0:
        moved = (p2[n] - p0[n]).abs().mean().item()
        assert moved > 0 and (ema[n] - p0[n]).abs().mean().item() < moved, n
    for i in (1, 2):
        assert np.isfinite(got[f"loss_{i}"].item())
        np.testing.assert_allclose(got[f"loss_{i}"].item(), want[f"loss_{i}"].item(), rtol=2e-5)


@pytest.mark.parametrize("what", ["sam", "vae_mean", "vae_sample", "vae_decode"])
@pytest.mark.parametrize("rank", RANKS)
def test_map_sharded_conditioning_matches_one_process(runs, what, rank):
    got = runs[0]["ranks"][rank]["conditioning"][what]
    want = runs[0]["single"]["conditioning"][what]
    assert got.shape == want.shape and got.shape[0] == entry.DRYRUN_FRAME_BATCH
    _allclose(got, want)


@pytest.mark.parametrize("rank", RANKS)
def test_gather_views_gradient_matches_one_process(runs, rank):
    _allclose(runs[0]["ranks"][rank]["gather_grad"], runs[0]["single"]["gather_grad"],
              atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# per-shard shapes of full_dual_config (fault F3) and the layouts
# ---------------------------------------------------------------------------

WORLDS = [2, 4, 5, 10, 20]
# the sites of CUDA_SITES whose batch rows are perspective views (B*M*F,
# B*M*HW or B*M folds), and the WarpAttn sites whose queries are
# perspective pixels ((m, h, w)-major: a rank keeps a contiguous block)
PERS_BATCH = {"pers_spatial_s0", "pers_spatial_s1", "pers_spatial_s2", "pers_text_cross",
              "pers_ip_cross", "motion_tiny_seq", "resampler_pers"}
PERS_QUERY = {"warp_s2_pers_q", "warp_s4_pers_q", "warp_s8_pers_q"}


# the sites whose queries are pano latent rows (H-major tokens: a rank keeps a
# contiguous block of every frame's tokens) where the rows shard
PANO_ROWS = {"pano_spatial_s0", "pano_spatial_s1", "pano_spatial_s2", "pano_spatial_s3",
             "pano_text_cross_s0", "pano_text_cross_s1", "warp_s2_pano_q", "warp_s4_pano_q",
             "warp_s8_pano_q"}
FULL_PANO_ROWS, FULL_LEVELS = 64, 4      # full_dual_config at 512 x 1024


def _rows_shard(world):
    with tmesh.activate_mesh(tmesh.Mesh(world, 0, 1, torch.device("cpu"))):
        return tmesh.pano_row_mesh(FULL_PANO_ROWS, FULL_LEVELS) is not None


def _per_shard(label, shape, world):
    B, Sq, Sk, H, D = shape
    if label in PERS_BATCH:
        assert B % world == 0, (label, B, world)
        return (B // world, Sq, Sk, H, D)
    if label in PERS_QUERY or (label in PANO_ROWS and _rows_shard(world)):
        assert Sq % world == 0, (label, Sq, world)
        return (B, Sq // world, Sk, H, D)
    return shape


@pytest.mark.parametrize("world,shards", [(1, True), (2, True), (4, True), (5, False),
                                          (10, False), (20, False)])
def test_the_pano_rows_shard_where_every_stage_height_divides(world, shards):
    """full_dual_config at 512 x 1024: stage heights 64 / 32 / 16 / 8."""
    assert _rows_shard(world) is shards
    with tmesh.activate_mesh(tmesh.Mesh(world, world - 1, 1, torch.device("cpu"))) as mesh:
        assert (tmesh.pano_row_mesh(FULL_PANO_ROWS, FULL_LEVELS) is mesh) is shards
        layout = tmesh.pano_layout(FULL_PANO_ROWS, FULL_LEVELS)
        assert layout.startswith("pano rows sharded" if shards else "pano replicated")
        assert "64/32/16/8" in layout
    assert tmesh.pano_row_mesh(FULL_PANO_ROWS, FULL_LEVELS) is None


@pytest.mark.parametrize("needs_grad", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("world", WORLDS)
def test_per_shard_shapes_take_the_whole_shapes_kernel(world, needs_grad):
    for label, shape, bias, _ in CUDA_SITES:
        want = select_attention_route(*shape, bias, on_cuda=True, needs_grad=needs_grad)
        got = select_attention_route(*_per_shard(label, shape, world), bias, on_cuda=True,
                                     needs_grad=needs_grad)
        assert got == want and got not in ("einsum", "chunked"), (label, world)


@pytest.fixture(scope="module")
def geoms_by_rank():
    """The WarpAttn geometry of 20 views (tiny_dual_config: the four levels
    of full_dual_config at narrow widths, latents of 8 x 8 and 8 x 16),
    whole and as each rank of a world of 4 and of 20 keeps it (only the
    slicing reads the mesh here: no process group)."""
    cfg = tiny_dual_config(num_views=20)
    rig = TCameraRig.icosahedron(image_size=64)
    build = lambda: t_build_geoms(cfg, rig, (8, 8), (8, 16), device="cpu")  # noqa: E731
    whole = build()
    per_rank = {}
    for world in (4, 20):
        for rank in range(world):
            with tmesh.activate_mesh(tmesh.Mesh(world, rank, 1, torch.device("cpu"))):
                per_rank[world, rank] = build()
    return whole, per_rank


@pytest.mark.parametrize("world", [4, 20])
def test_each_rank_keeps_its_bias_rows_and_pe_views(geoms_by_rank, world):
    """The perspective-query bias reaches K3 as this rank's [Sq/W, Sk] rows
    of one shared matrix (a [1, 1, Sq/W, Sk] bias: the "shared_bias"
    route, with and without grad), the pano-query bias and PE whole, the
    perspective PE this rank's views."""
    whole, per_rank = geoms_by_rank
    for rank in range(world):
        got = per_rank[world, rank]
        for rkey in ("r2", "r4", "r8"):
            for tag in ("", "_opp"):
                full, part = whole[rkey]["equi_bias" + tag], got[rkey]["equi_bias" + tag]
                n = full.shape[0] // world
                assert part.shape == (n, full.shape[1]) and part.is_contiguous()
                assert torch.equal(part, full[rank * n:(rank + 1) * n])
                assert torch.equal(got[rkey]["pers_bias" + tag], whole[rkey]["pers_bias" + tag])
                bias = part[None, None]
                for needs_grad in (False, True):
                    assert select_attention_route(
                        32, n, full.shape[1], 2, 32, True, on_cuda=True, needs_grad=needs_grad,
                        bias_is_shared=bias.shape[:2] == (1, 1)) == "shared_bias"
        for name, pe in got["pe"].items():
            v = 20 // world
            assert torch.equal(pe["pers_pe"], whole["pe"][name]["pers_pe"][rank * v:(rank + 1) * v])
            assert torch.equal(pe["equi_pe"], whole["pe"][name]["equi_pe"])


@pytest.fixture(scope="module")
def pano_geoms_by_rank():
    """As geoms_by_rank with a pano latent of 32 x 64 (stage heights
    32 / 16 / 8 / 4, rows sharded at 2 and 4 ranks)."""
    cfg = tiny_dual_config(num_views=20)
    rig = TCameraRig.icosahedron(image_size=64)
    build = lambda: t_build_geoms(cfg, rig, (8, 8), (32, 64), device="cpu")  # noqa: E731
    whole = build()
    per_rank = {}
    for world in (2, 4):
        for rank in range(world):
            with tmesh.activate_mesh(tmesh.Mesh(world, rank, 1, torch.device("cpu"))):
                per_rank[world, rank] = build()
    return whole, per_rank


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_keeps_its_pano_rows_of_the_bias_and_pe(pano_geoms_by_rank, world):
    """Where the pano's rows shard, the pano-query bias reaches K3 as this
    rank's block of latent rows (a [1, 1, Sq/W, Sk] bias: the
    "shared_bias" route, with and without grad) and the pano PE as this
    rank's rows; the perspective-query bias and PE keep this rank's views."""
    whole, per_rank = pano_geoms_by_rank
    for rank in range(world):
        got = per_rank[world, rank]
        for rkey, s in (("r2", 2), ("r4", 4), ("r8", 8)):
            row_len = 64 // s
            for tag in ("", "_opp"):
                full, part = whole[rkey]["pers_bias" + tag], got[rkey]["pers_bias" + tag]
                n = 32 // s // world * row_len
                assert part.shape == (n, full.shape[1]) and part.is_contiguous()
                assert torch.equal(part, full[rank * n:(rank + 1) * n])
                for needs_grad in (False, True):
                    assert select_attention_route(
                        32, n, full.shape[1], 2, 32, True, on_cuda=True,
                        needs_grad=needs_grad, bias_is_shared=True) == "shared_bias"
                full, part = whole[rkey]["equi_bias" + tag], got[rkey]["equi_bias" + tag]
                v = full.shape[0] // world
                assert torch.equal(part, full[rank * v:(rank + 1) * v])
        for name, pe in got["pe"].items():
            full = whole["pe"][name]["equi_pe"]
            n = full.shape[0] // world
            assert pe["equi_pe"].shape == (n, *full.shape[1:])
            assert torch.equal(pe["equi_pe"], full[rank * n:(rank + 1) * n])
            v = 20 // world
            assert torch.equal(pe["pers_pe"], whole["pe"][name]["pers_pe"][rank * v:(rank + 1) * v])


@pytest.mark.parametrize("world,replicas", [(4, 2), (4, 1), (2, 2)])
def test_shard_frames_and_shard_batch_keep_each_ranks_block(world, replicas):
    """Ranks are replica-major (rank = replica * view_size + view): the
    frames split over the view ranks, the clips and the batch over the
    replicas; a dimension that does not divide stays whole."""
    x = torch.arange(4 * 12 * 3.0).reshape(4, 12, 3)
    odd = torch.arange(15.0).reshape(3, 5)
    view_size = world // replicas
    for rank in range(world):
        replica, view = divmod(rank, view_size)
        with tmesh.activate_mesh(tmesh.Mesh(world, rank, replicas, torch.device("cpu"))):
            b, f = 4 // replicas, 12 // view_size
            assert torch.equal(tmesh.shard_frames(x),
                               x[replica * b:(replica + 1) * b, view * f:(view + 1) * f])
            assert torch.equal(tmesh.shard_batch(x), x[replica * b:(replica + 1) * b])
            assert torch.equal(tmesh.shard_frames(odd), odd)
            assert torch.equal(tmesh.shard_batch(odd), odd)
    for y in (tmesh.shard_frames(x), tmesh.shard_batch(x)):
        assert torch.equal(y, x)


@pytest.mark.parametrize("world,replicas,match", [
    (3, 1, "must be one of \\[1, 2, 4, 5, 10, 20\\]"),
    (8, 1, "20 views do not divide over 8 ranks"),
    (2, 3, "mesh_replicas 3 does not divide the world size 2"),
    (4, 0, "mesh_replicas 0"),
])
def test_a_layout_the_mesh_cannot_take_raises(world, replicas, match):
    with pytest.raises(ValueError, match=match):
        tmesh.check_layout(world, replicas, views=20)
    with tmesh.activate_mesh(tmesh.Mesh(world, 0, max(replicas, 1), torch.device("cpu"))):
        if 20 % world:
            with pytest.raises(ValueError, match="views do not divide"):
                tmesh.view_slice(20)


def test_helpers_are_the_identity_without_a_mesh():
    x = torch.arange(24.0).reshape(2, 4, 3)
    assert tmesh.current_mesh() is None
    assert tmesh.view_slice(4) == slice(0, 4)
    for y in (tmesh.shard_views(x, 1), tmesh.gather_views(x, 1), tmesh.reduce_sum(x),
              tmesh.map_sharded(lambda t: t, x)):
        assert torch.equal(y, x)
    with tmesh.activate_mesh(tmesh.Mesh(2, 1, 1, torch.device("cpu"))):
        assert torch.equal(tmesh.shard_views(x, 1), x[:, 2:])
        assert torch.equal(tmesh.shard_views(x.reshape(8, 3), 0, batch=2),
                           x[:, 2:].reshape(4, 3))
