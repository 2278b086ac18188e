"""In-step augmentation of the port (tpu3dlm_torch/ops/augment.py) against
the JAX package's (tpu3dlm/ops/augment.py) on the CPU. The reference draws
from JAX keys; each case replays those draws (tests/torch_jax_noise.py)
and feeds them to the port's deterministic applies. Bars: images within
1e-6, boxes within 1e-5 px (one f32 ulp at 64 px is 7.6e-6), masks and
uint8 crops identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_noise as N

from tpu3dlm.ops import augment as JA
from tpu3dlm_torch.ops import augment as PA

S = 64
KEYS = range(6)


def batch(n=4, g=3, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(n, S, S, 3)).astype(np.float32)
    xy = rng.uniform(0, S * 0.7, (n, g, 2))
    wh = rng.uniform(3, S * 0.4, (n, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, S - 1)], -1).astype(np.float32)
    mask = rng.uniform(size=(n, g)) < 0.8
    return imgs, boxes, mask


def close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def per_image_keys(key, n):
    return jax.random.split(key, n)


@pytest.mark.parametrize("seed", KEYS)
def test_hflip_matches_jax(seed):
    imgs, boxes, _ = batch()
    keys = per_image_keys(jax.random.PRNGKey(seed), len(imgs))
    ji, jb = jax.vmap(lambda k, i, b: JA._hflip(k, i, b, 0.5))(keys, imgs, boxes)
    flip = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5))(keys)))
    pi, pb = PA.hflip(torch.from_numpy(imgs), torch.from_numpy(boxes), flip)
    close(pi, ji, 0.0)
    close(pb, jb, 1e-5)


@pytest.mark.parametrize("seed", KEYS)
def test_color_jitter_matches_jax(seed):
    imgs, _, _ = batch()
    keys = per_image_keys(jax.random.PRNGKey(seed), len(imgs))
    want = jax.vmap(lambda k, i: JA._color_jitter(k, i, 0.3, 0.3))(keys, imgs)

    def draws(k):
        kb, kc = jax.random.split(k)
        return (jax.random.uniform(kb, (), minval=-0.3, maxval=0.3),
                jax.random.uniform(kc, (), minval=0.7, maxval=1.3))

    b, c = jax.vmap(draws)(keys)
    got = PA.color_jitter(torch.from_numpy(imgs), torch.from_numpy(np.array(b)), torch.from_numpy(np.array(c)))
    close(got, want, 1e-6)


@pytest.mark.parametrize("seed", KEYS)
def test_crop_zoom_matches_jax(seed):
    imgs, boxes, mask = batch(n=8)
    keys = per_image_keys(jax.random.PRNGKey(seed), len(imgs))
    ji, jb, jm = jax.vmap(lambda k, i, b, m: JA._crop_zoom(k, i, b, m, 0.5, 0.5))(keys, imgs, boxes, mask)

    def draws(k):
        kd, kz, kx, ky = jax.random.split(k, 4)
        return (jax.random.bernoulli(kd, 0.5), jax.random.uniform(kz, (), minval=0.5, maxval=1.0),
                jax.random.uniform(kx, ()), jax.random.uniform(ky, ()))

    noise = [torch.from_numpy(np.array(x)) for x in jax.vmap(draws)(keys)]
    pi, pb, pm = PA.crop_zoom(torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(mask), *noise)
    close(pi, ji, 1e-6)
    close(pb, jb, 1e-5)
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    # the un-zoomed images are the inputs bit for bit
    off = ~noise[0].numpy()
    assert off.any() and np.array_equal(pi.numpy()[off], imgs[off])


@pytest.mark.parametrize("seed", KEYS)
def test_erase_one_and_erase_match_jax(seed):
    imgs, _, _ = batch()
    keys = per_image_keys(jax.random.PRNGKey(seed), len(imgs))
    want_one = jax.vmap(lambda k, i: JA._erase_one(k, i, 0.35))(keys, imgs)
    one = N._stack([N._erase_one(k, 0.35) for k in keys])
    got_one = PA.erase_one(torch.from_numpy(imgs), *[one[k] for k in ("erase_w", "erase_h", "erase_x",
                                                                      "erase_y", "erase_color")])
    close(got_one, want_one, 0.0)

    want = jax.vmap(lambda k, i: JA._erase(k, i, 0.5, 3, 0.35))(keys, imgs)
    patches = []  # _erase's draws: each patch from fold_in(key, i), the key passed on
    for k in keys:
        rows, key = [], k
        for i in range(3):
            kd, ke, key = jax.random.split(jax.random.fold_in(key, i), 3)
            rows.append({"erase": jax.random.bernoulli(kd, 0.5), **N._erase_one(ke, 0.35)})
        patches.append({name: jnp.stack([r[name] for r in rows]) for name in rows[0]})
    n = N._stack(patches)
    got = PA.erase(torch.from_numpy(imgs), n["erase"], n["erase_w"], n["erase_h"], n["erase_x"], n["erase_y"],
                   n["erase_color"])
    close(got, want, 0.0)


@pytest.mark.parametrize("options", [{}, {"erase_p": 0.5, "brightness": 0.3, "contrast": 0.3},
                                     {"zoom_p": 1.0, "zoom_min": 0.5, "hflip_p": 1.0}],
                         ids=["defaults", "hard_recipe", "always_zoom_and_flip"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_detection_batch_matches_jax(options, seed):
    imgs, boxes, mask = batch(n=5, seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    ji, jb, jm = JA.augment_detection_batch(key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(mask),
                                            **options)
    noise = N.detection_noise(key, len(imgs), **options)
    assert ("erase" in noise) == ("erase_p" in options)
    pi, pb, pm = PA.augment_detection_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                            torch.from_numpy(mask), noise=noise)
    close(pi, ji, 1e-6)
    close(pb, jb, 1e-5)
    assert np.array_equal(pm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("options", [{}, {"hflip_p": 0.0, "erase_p": 0.0}, {"erase_p": 1.0, "offset": 60.0}],
                         ids=["defaults", "gain_only", "always_erase"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_crop_batch_matches_jax(options, seed):
    crops = np.random.default_rng(seed).integers(0, 256, (24, 32, 32, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(200 + seed)
    want = np.asarray(JA.augment_crop_batch(key, jnp.asarray(crops), **options))
    got = PA.augment_crop_batch(torch.from_numpy(crops), noise=N.crop_noise(key, len(crops), **options))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


# the identity cases of tests/test_augment.py, on the port's own draws

def port_batch(**kw):
    imgs, boxes, mask = batch()
    out = PA.augment_detection_batch(torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(mask),
                                     generator=torch.Generator().manual_seed(7), **kw)
    return (imgs, boxes, mask), out


def test_all_off_is_identity():
    (imgs, boxes, mask), out = port_batch(hflip_p=0.0, brightness=0.0, contrast=0.0, zoom_p=0.0)
    close(out[0], imgs, 1e-6)
    assert np.array_equal(out[1].numpy(), boxes) and np.array_equal(out[2].numpy(), mask)


def test_forced_hflip_mirrors_image_and_boxes():
    (imgs, boxes, _), out = port_batch(hflip_p=1.0, brightness=0.0, contrast=0.0, zoom_p=0.0)
    close(out[0], imgs[:, :, ::-1, :], 1e-6)
    close(out[1][..., 0], (S - 1.0) - boxes[..., 2], 1e-5)
    close(out[1][..., 2], (S - 1.0) - boxes[..., 0], 1e-5)
    close(out[1][..., [1, 3]], boxes[..., [1, 3]], 1e-5)


def test_identity_zoom_is_exact():
    (imgs, boxes, mask), out = port_batch(hflip_p=0.0, brightness=0.0, contrast=0.0, zoom_p=1.0, zoom_min=1.0)
    close(out[0], imgs, 1e-5)
    close(out[1], boxes, 1e-3)
    assert np.array_equal(out[2].numpy(), mask)


def test_boxes_stay_in_frame_and_draws_are_seeded():
    (_, _, _), out = port_batch(zoom_p=1.0, zoom_min=0.5)
    assert out[1].min() >= -1e-3 and out[1].max() <= (S - 1.0) + 1e-3
    (_, _, _), again = port_batch(zoom_p=1.0, zoom_min=0.5)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_crop_gain_reaches_dark_and_bright():
    crops = torch.full((64, 16, 16, 3), 128, dtype=torch.uint8)
    out = PA.augment_crop_batch(crops, generator=torch.Generator().manual_seed(0), hflip_p=0.0, erase_p=0.0)
    means = out.float().reshape(64, -1).mean(1)
    assert means.min() < 80 and means.max() > 180


def test_a_step_without_noise_or_generator_raises():
    imgs, boxes, mask = batch()
    with pytest.raises(ValueError):
        PA.augment_detection_batch(torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(mask))
    with pytest.raises(TypeError):
        PA.draw_crop_noise(3, torch.Generator(), zoom_p=1.0)
