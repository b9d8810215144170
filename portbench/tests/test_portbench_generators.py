"""The traffic and the weights repeat bit for bit from a seed, and every
seed gets the same set of sizes."""

import numpy as np
import torch

from portbench import traffic, weights
from portbench.tests.conftest import DEV

BLOCK = {"kind": "audio_split", "pool_files": 3, "median_s": 40, "sigma": 0.35, "min_s": 30,
         "max_s": 600, "sample_rate": 44100, "n_versions": 10, "clique_size": 2}


def test_pool_lengths_are_fixed_quantiles():
    full = dict(BLOCK, pool_files=48, median_s=210)
    lengths = traffic.pool_lengths(full)
    assert lengths == traffic.pool_lengths(full)
    assert len(lengths) == 48 and min(lengths) >= 30 and max(lengths) <= 600
    assert sorted(lengths)[24] in range(205, 216)  # the median


def test_pool_repeats_bit_for_bit(cache, tmp_path):
    first = [p.read_bytes() for p in traffic.audio_pool(BLOCK)]
    import shutil

    shutil.rmtree(cache)
    second = [p.read_bytes() for p in traffic.audio_pool(BLOCK)]
    assert first == second
    assert len(first[0]) == 44 + 2 * 30 * 44100  # the shortest: 30 s of 16-bit mono


def test_no_stretch_of_the_pool_repeats(cache):
    """Two sections (chunks) of a file, or of two files, and two seconds of
    one section carry different signals: a row placed in the wrong chunk or
    song reads wrong."""
    import wave

    block = dict(BLOCK, median_s=95, sigma=0.0)
    sr, sections = block["sample_rate"], []
    for p in traffic.audio_pool(block):
        with wave.open(str(p)) as w:
            x = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64)
        sections += [x[a:a + 30 * sr] for a in range(0, 90 * sr, 30 * sr)]

    def corr(a, b):
        return abs(float(np.dot(a, b) / np.sqrt(np.dot(a, a) * np.dot(b, b))))

    for i, a in enumerate(sections):
        assert a.std() > 100  # well above the 16-bit floor
        assert corr(a[:-sr], a[sr:]) < 0.5  # no period of a second
        for b in sections[i + 1:]:
            assert corr(a, b) < 0.1


def test_order_is_a_seeded_shuffle_of_the_same_mix():
    a, b = traffic.pool_order(48, 4096, 2**31 + 11), traffic.pool_order(48, 4096, 2**31 + 11)
    c = traffic.pool_order(48, 4096, 7)
    assert (a == b).all() and not (a == c).all()
    # every whole pass over the pool holds each file once, whatever the seed
    for k in range(4096 // 48):
        assert sorted(a[48 * k:48 * (k + 1)]) == sorted(c[48 * k:48 * (k + 1)]) == list(range(48))


def test_project_repeats(cache, tmp_path):
    p1 = traffic.audio_project(tmp_path / "a", BLOCK, 2**33 + 1, "dev")
    p2 = traffic.audio_project(tmp_path / "b", BLOCK, 2**33 + 1, "dev")
    assert p1["versions"] == p2["versions"] and len(p1["versions"]) == 10
    assert (tmp_path / "a" / "lc" / "test_no_dup.csv").read_bytes() == \
        (tmp_path / "b" / "lc" / "test_no_dup.csv").read_bytes()


def test_weights_repeat_from_the_seed():
    cpu = torch.device("cpu")
    a = weights.whisper_state_dict(DEV, 2**32 + 3, cpu)
    b = weights.whisper_state_dict(DEV, 2**32 + 3, cpu)
    c = weights.whisper_state_dict(DEV, 5, cpu)
    assert a.keys() == b.keys() == weights.shapes(DEV).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv1.weight"], c["encoder.conv1.weight"])
    assert torch.equal(a["encoder.positional_embedding"], c["encoder.positional_embedding"])
