"""CPU parity of the port's framing ops (wealy_tpu_torch/ops/framing.py)
with the JAX package's (wealy_tpu/ops/framing.py), mirroring
tests/test_ops_framing.py on the same numpy arrays: exact equality where
the result is a pure function of the input. The random modes draw from a
``torch.Generator`` where JAX takes a PRNG key, so a random cut or pad is
held by its properties (a contiguous window; blocks of the input or zeros),
with a given seed repeating its draw (ROADMAP §3, deviations)."""

import jax
import numpy as np
import pytest
import torch

from wealy_tpu.ops import framing as J
from wealy_tpu_torch.ops import framing as F


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


class TestForceLength:
    def test_noop_when_exact(self, rng):
        x = rng.normal(size=(3, 10)).astype(np.float32)
        _same(F.force_length(torch.from_numpy(x), 10), J.force_length(x, 10))
        _same(F.force_length(torch.from_numpy(x), 10), x)

    def test_repeat_pad(self):
        x = np.array([[1.0, 2.0, 3.0]], np.float32)
        got = F.force_length(torch.from_numpy(x), 7, pad_mode="repeat")
        _same(got, J.force_length(x, 7, pad_mode="repeat"))
        _same(got, [[1, 2, 3, 1, 2, 3, 1]])

    def test_zeros_pad(self):
        x = np.array([[1.0, 2.0, 3.0]], np.float32)
        got = F.force_length(torch.from_numpy(x), 5, pad_mode="zeros")
        _same(got, J.force_length(x, 5, pad_mode="zeros"))
        _same(got, [[1, 2, 3, 0, 0]])

    def test_cut_start_end(self):
        x = np.arange(10, dtype=np.float32)[None]
        for mode, want in (("start", [[0, 1, 2, 3]]), ("end", [[6, 7, 8, 9]])):
            got = F.force_length(torch.from_numpy(x), 4, cut_mode=mode)
            _same(got, J.force_length(x, 4, cut_mode=mode))
            _same(got, want)

    def test_cut_random_window(self):
        x = np.arange(10, dtype=np.float32)[None]
        jout = np.asarray(J.force_length(x, 4, cut_mode="random", key=jax.random.PRNGKey(0)))
        for seed in range(8):
            out = F.force_length(torch.from_numpy(x), 4, cut_mode="random",
                                 generator=torch.Generator().manual_seed(seed)).numpy()
            for o in (out, jout):  # a contiguous window, on both sides
                assert o.shape == (1, 4)
                np.testing.assert_array_equal(o[0], np.arange(o[0, 0], o[0, 0] + 4))
            again = F.force_length(torch.from_numpy(x), 4, cut_mode="random",
                                   generator=torch.Generator().manual_seed(seed))
            _same(again, out)
        with pytest.raises(ValueError, match="Generator"):
            F.force_length(torch.from_numpy(x), 4, cut_mode="random")

    def test_crazy_pad_shape_and_content(self):
        x = np.array([[1.0, 2.0]], np.float32)
        jout = np.asarray(J.force_length(x, 8, pad_mode="crazy", key=jax.random.PRNGKey(1)))
        outs = set()
        for seed in range(16):
            out = F.force_length(torch.from_numpy(x), 8, pad_mode="crazy",
                                 generator=torch.Generator().manual_seed(seed)).numpy()
            for o in (out, jout):
                assert o.shape == (1, 8)
                assert set(np.unique(o)).issubset({0.0, 1.0, 2.0})
                # built from whole blocks: x or zeros at every even offset
                blocks = o[0].reshape(4, 2)
                assert all(list(b) in ([1.0, 2.0], [0.0, 0.0]) for b in blocks)
            outs.add(out.tobytes())
        assert len(outs) > 1  # the draws vary with the seed
        with pytest.raises(ValueError, match="Generator"):
            F.force_length(torch.from_numpy(x), 8, pad_mode="crazy")

    def test_allow_longer(self):
        x = np.arange(10, dtype=np.float32)[None]
        got = F.force_length(torch.from_numpy(x), 4, allow_longer=True)
        assert got.shape == (1, 10)
        _same(got, J.force_length(x, 4, allow_longer=True))

    def test_axis_arg(self, rng):
        x = rng.normal(size=(5, 3)).astype(np.float32)
        got = F.force_length(torch.from_numpy(x), 8, axis=0, pad_mode="zeros")
        assert got.shape == (8, 3)
        _same(got, J.force_length(x, 8, axis=0, pad_mode="zeros"))


class TestFrames:
    def test_matches_torch_unfold(self, rng):
        x = rng.normal(size=(2, 23)).astype(np.float32)
        got = F.frames(torch.from_numpy(x), 5, 3)
        _same(got, J.frames(x, 5, 3))
        _same(got, torch.tensor(x).unfold(-1, 5, 3))

    def test_pad_end(self, rng):
        x = rng.normal(size=(25,)).astype(np.float32)
        got = F.frames(torch.from_numpy(x), 10, 6, pad_end=True)
        _same(got, J.frames(x, 10, 6, pad_end=True))
        assert got.shape == (4, 10)

    def test_middle_axis(self, rng):
        x = rng.normal(size=(2, 20, 3)).astype(np.float32)
        got = F.frames(torch.from_numpy(x), 4, 4, axis=1)
        assert got.shape == (2, 5, 3, 4)
        _same(got, J.frames(x, 4, 4, axis=1))
        # a middle axis with an end pad and a pad value
        got = F.frames(torch.from_numpy(x), 6, 4, pad_end=True, pad_value=-1.0, axis=1)
        _same(got, J.frames(x, 6, 4, pad_end=True, pad_value=-1.0, axis=1))


class TestGetFrames:
    def test_pads_to_cover_tail(self, rng):
        x = rng.normal(size=(1, 25)).astype(np.float32)
        got = F.get_frames(torch.from_numpy(x), 10, 6)
        # ceil((25-10)/6)*6 + 10 = 28 -> 4 frames
        assert got.shape == (1, 4, 10)
        _same(got, J.get_frames(x, 10, 6))
        np.testing.assert_array_equal(got.numpy()[0, -1, 7:], 0.0)

    def test_no_pad(self, rng):
        x = rng.normal(size=(1, 30)).astype(np.float32)
        got = F.get_frames(torch.from_numpy(x), 10, 10, pad_end=False)
        assert got.shape == (1, 3, 10)
        _same(got, J.get_frames(x, 10, 10, pad_end=False))

    def test_jit(self, rng):
        """The JAX test jits get_frames; the port's agrees with the jitted
        JAX function on the same array, with the repeat pad too."""
        x = rng.normal(size=(1, 25)).astype(np.float32)
        f = jax.jit(lambda a: J.get_frames(a, 10, 6, pad_mode="repeat"))
        got = F.get_frames(torch.from_numpy(x), 10, 6, pad_mode="repeat")
        assert got.shape == (1, 4, 10)
        _same(got, f(x))
