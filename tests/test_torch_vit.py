"""The port's ViT (config 3) against fft_tpu's on the CPU: the forward at an
odd length and at L = 197 with the wavelet branch on and off, the
classification loss and every gradient, train-vit's optimizer step, the
synthetic and image-folder data, and the train-vit CLI with a checkpoint
and a resume.

Both sides run ``fft_impl="auto"`` (the per-head branch).  The wavelet
masks cannot match JAX's draws, so parity runs at ``wavelet_on_rate`` 0.0
and 1.0 (and in eval mode, where JAX's ``deterministic=True`` rounds the
rate).  Tolerances are max|a-b| / max|b| (tests/golden_utils.py): 1e-4 for
logits, the loss and gradients (12 FFT round trips a forward), 1e-5 for
the optimizer fed the same gradients."""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fft_tpu.config as jcfg_mod
import fft_tpu.models.vit as jvit
import fft_tpu.train.images as jimages
import fft_tpu.train.loop as jloop
from fft_tpu_torch import cli
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import vit_from_jax_params
from fft_tpu_torch.models import vit as tvit
from fft_tpu_torch.train import (
    AdamW, classification_loss, train_init, vit_train_config, vit_train_step,
)
from fft_tpu_torch.train import images as timages
from tests.golden_utils import rel_err
from tests.test_torch_convert import _leaf_init

MODEL_TOL = 1e-4
OPT_TOL = 1e-5


def jax_vit_config(cfg: tvit.ViTConfig) -> jvit.ViTConfig:
    block = jcfg_mod.SpectreConfig(**dataclasses.asdict(cfg.block))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "block"}
    return jvit.ViTConfig(block=block, **fields)


def small_vit(wavelet: float = 1.0, image: int = 32, patch: int = 8,
              n_fft: int = 32, pool: str = "cls") -> tvit.ViTConfig:
    """2 layers, d=64, 2 heads, mean pooling, 10 classes; 32 x 32 images in
    8 x 8 patches: L = 17, an odd length for the wavelet pyramid."""
    return tvit.ViTConfig(
        image_size=image, patch_size=patch, num_classes=10, num_layers=2,
        block=SpectreConfig(embed_dim=64, num_heads=2, n_fft=n_fft,
                            pooling_type="mean", wavelet_on_rate=wavelet),
        pool=pool)


def vit_pair(cfg: tvit.ViTConfig, seed: int = 0):
    """(JAX params as numpy, port model in eval mode) with the same
    numpy-seeded weights, bridged into the port."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jvit.vit_init(jax.random.key(0), jax_vit_config(cfg)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf_init(path, s.shape, rng).astype(np.float32),
        shapes)
    model = tvit.ViT(cfg)
    model.load_state_dict(vit_from_jax_params(params, cfg), strict=True)
    return params, model.eval()


def _images(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, b).astype(np.int32)
    return imgs, labels


def _port_grads(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad)
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("wavelet", [1.0, 0.0, 0.1])
@pytest.mark.parametrize("geometry", ["L17", "L197"])
def test_vit_logits_match_jax(wavelet, geometry):
    """At L = 17 (32 x 32 images, patch 8) and L = 197 (224 x 224, patch
    16, n_fft 256, the config's geometry on a narrow model); the wavelet
    on at 1.0, off at 0.0, and at the config's 0.1 in eval mode (off, as
    JAX's deterministic rule has it)."""
    cfg = (small_vit(wavelet) if geometry == "L17"
           else small_vit(wavelet, image=224, patch=16, n_fft=256))
    assert cfg.seq_len == (17 if geometry == "L17" else 197)
    params, model = vit_pair(cfg, seed=1)
    imgs, _ = _images(cfg, 2)
    want = jvit.vit_apply(jax.tree.map(jnp.asarray, params),
                          jax_vit_config(cfg), jnp.asarray(imgs))
    with torch.no_grad():
        got = tvit.vit_apply(model, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(got.numpy(), np.asarray(want)) < MODEL_TOL


def test_vit_mean_pool_matches_jax():
    cfg = small_vit(pool="mean")
    params, model = vit_pair(cfg, seed=3)
    imgs, _ = _images(cfg, 3)
    want = jvit.vit_apply(jax.tree.map(jnp.asarray, params),
                          jax_vit_config(cfg), jnp.asarray(imgs))
    with torch.no_grad():
        got = tvit.vit_apply(model, torch.from_numpy(imgs))
    assert rel_err(got.numpy(), np.asarray(want)) < MODEL_TOL


def test_classification_loss_and_every_gradient_match_jax():
    """The wavelet on (rate 1.0): its gate MLP gets gradients, its pyramid
    is detached on both sides."""
    cfg = small_vit(1.0)
    params, model = vit_pair(cfg, seed=4)
    imgs, labels = _images(cfg, 4, b=3)
    loss, grads = jax.value_and_grad(jloop.classification_loss)(
        jax.tree.map(jnp.asarray, params), jax_vit_config(cfg),
        jnp.asarray(imgs), jnp.asarray(labels), deterministic=True)
    got = classification_loss(model, torch.from_numpy(imgs),
                              torch.from_numpy(labels))
    got.backward()
    assert abs(float(got.detach()) - float(loss)) / float(loss) < MODEL_TOL
    want = vit_from_jax_params(jax.tree.map(np.asarray, grads), cfg)
    port = _port_grads(model)
    assert sorted(want) == sorted(port)
    assert float(port["blocks.0.mix.wavelet.fc1.weight"].abs().max()) > 0
    for name, g in port.items():
        assert rel_err(g.numpy(), want[name].numpy()) < MODEL_TOL, name


def test_train_vit_step_matches_optax_adamw():
    """train-vit's step: JAX's (cli.py:349-358, optax.adamw(lr), the
    wavelet at rate 1.0 so its mask draws nothing) against the port's
    vit_train_step, twice: the loss, and every parameter after the steps;
    then the port's AdamW(vit_train_config) against optax.adamw fed the
    same gradients, 1e-5."""
    cfg = small_vit(1.0)
    params, model = vit_pair(cfg, seed=5)
    imgs, labels = _images(cfg, 5, b=4)
    lr = 1e-4
    opt = optax.adamw(lr)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = opt.init(jp)
    jcfg = jax_vit_config(cfg)
    state = train_init(model, vit_train_config(lr), seed=0)
    assert model.training

    @jax.jit
    def jstep(p, s):
        loss, grads = jax.value_and_grad(jloop.classification_loss)(
            p, jcfg, jnp.asarray(imgs), jnp.asarray(labels),
            rngs={"dropout": jax.random.key(0)}, deterministic=False)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    for _ in range(2):
        jp, opt_state, loss = jstep(jp, opt_state)
        got = vit_train_step(state, imgs, labels)
        assert abs(float(got["loss"]) - float(loss)) / float(loss) \
            < MODEL_TOL
    ref = vit_from_jax_params(jax.tree.map(np.asarray, jp), cfg)
    for name, p in model.named_parameters():
        assert rel_err(p.detach().numpy(), ref[name].numpy()) < MODEL_TOL, \
            name
    # the optimizer alone, the same gradients on both sides
    rng = np.random.default_rng(6)
    g = [rng.standard_normal(tuple(p.shape)).astype(np.float32) * 10.0
         for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    jtree = {n: jnp.asarray(p.detach().numpy())
             for n, p in model.named_parameters()}
    opt_state = opt.init(jtree)
    ours = AdamW(model.parameters(), vit_train_config(lr))
    jg = {n: jnp.asarray(a) for n, a in zip(names, g)}
    update = jax.jit(lambda t, s: opt.update(jg, s, t))
    for _ in range(3):
        updates, opt_state = update(jtree, opt_state)
        jtree = optax.apply_updates(jtree, updates)
        ours.step([torch.from_numpy(a) for a in g])
    for name, p in model.named_parameters():
        assert rel_err(p.detach().numpy(), np.asarray(jtree[name])) \
            < OPT_TOL, name


def test_train_mode_draws_the_wavelet_per_layer_from_the_generator():
    """At rate 0.5 in train mode the masks come from the step's generator:
    one seed gives one output, and the draws differ across seeds."""
    cfg = small_vit(0.5)
    _, model = vit_pair(cfg, seed=7)
    model.train()
    imgs, _ = _images(cfg, 7, b=8)
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        a = tvit.vit_apply(model, x, generator=torch.Generator().manual_seed(1))
        b = tvit.vit_apply(model, x, generator=torch.Generator().manual_seed(1))
        outs = {tuple(tvit.vit_apply(
            model, x, generator=torch.Generator().manual_seed(s))[:, 0]
            .tolist()) for s in range(4)}
    assert torch.equal(a, b) and len(outs) > 1
    with pytest.raises(ValueError, match="generator"):
        tvit.vit_apply(model, x)


def test_synthetic_image_batches_equal_jax_byte_for_byte():
    ours = timages.synthetic_image_batches(4, 32, 10, seed=3)
    theirs = jimages.synthetic_image_batches(4, 32, 10, seed=3)
    for _ in range(3):
        (a, la), (b, lb) = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.float32 and la.dtype == lb.dtype
        assert a.tobytes() == b.tobytes() and la.tobytes() == lb.tobytes()


def _image_folder(root):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    for label, cls in enumerate(("cat", "dog", "eel")):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(3):
            arr = rng.integers(0, 255, (53, 40, 3)).astype("uint8")
            arr[:, :, 0] = 40 * label
            PIL.fromarray(arr).save(d / f"img_{i}.png")
    return root


def test_image_folder_batches_equal_jax(tmp_path):
    root = _image_folder(tmp_path / "data")
    ours = timages.ImageFolderDataset(str(root), image_size=32)
    theirs = jimages.ImageFolderDataset(str(root), image_size=32)
    assert ours.classes == theirs.classes and len(ours) == len(theirs) == 9
    for augment in (True, False):
        it_a = ours.batches(4, seed=2, augment=augment)
        it_b = theirs.batches(4, seed=2, augment=augment)
        for _ in range(4):                       # past one epoch
            (a, la), (b, lb) = next(it_a), next(it_b)
            assert a.tobytes() == b.tobytes() and la.tobytes() == lb.tobytes()
    assert np.array_equal(ours.example(3), theirs.example(3))


@functools.lru_cache(maxsize=None)
def _cli_lines(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return buf.getvalue()


def test_cli_train_vit_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    base = ["train-vit", "--device", "cpu", "--batch", "2", "--layers",
            "1", "--classes", "10", "--log-every", "1", "--ckpt", ck,
            "--ckpt-every", "2"]
    out = _cli_lines(*base, "--steps", "3")
    losses = [ln for ln in out.splitlines() if ln.startswith('{"step"')]
    assert len(losses) == 3
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "3"]
    out = _cli_lines(*base, "--steps", "4", "--resume")
    assert "resumed at step 3" in out
    assert [ln for ln in out.splitlines() if ln.startswith('{"step"')] \
        and '"step": 3' in out


def test_cli_train_vit_on_an_image_folder(tmp_path):
    root = _image_folder(tmp_path / "data")
    out = _cli_lines("train-vit", "--device", "cpu", "--batch", "2",
                     "--layers", "1", "--steps", "2", "--log-every", "1",
                     "--data", str(root))
    assert "--classes 1000 -> 3" in out


def test_vit_s_config_equals_jax():
    ours, want = tvit.vit_s_config(), jvit.vit_s_config()
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.seq_len == want.seq_len == 197
