"""Package-level checks of the PyTorch port (wealy_tpu_torch): it imports no
JAX (nor pandas, flax or orbax, which the card's machine lacks), its kernel
wrappers (forward and backward) count launches only when they launch, its
build raises without nvcc, its entry points refuse to run on the CPU unless
asked, and chip_smoke.py refuses to run without a card."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wealy_tpu_torch
from wealy_tpu_torch import _build
from wealy_tpu_torch.audio.fused_mel import log_mel_spectrogram_fused
from wealy_tpu_torch.audio.mel import N_SAMPLES
from wealy_tpu_torch.ops.bpwr_redux import bpwr_block_redux
from wealy_tpu_torch.ops.flash_attention import flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq
from wealy_tpu_torch.ops.fused_mlp import fused_mlp
from wealy_tpu_torch.ops.layer_norm import fused_layer_norm

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "wealy_tpu_torch"
# the serve daemon answers a failed request with an error and keeps serving;
# each such try line of cli/serve.py says so, and only those lines may
ERROR_ANSWER = "# an error answer, never a fallback"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(wealy_tpu_torch.__path__, "wealy_tpu_torch.")
    )


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return env


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "wealy_tpu_torch.models.whisper.extract" in mods
    assert "wealy_tpu_torch.cli.main" in mods
    assert {"wealy_tpu_torch.losses.clews", "wealy_tpu_torch.train.step",
            "wealy_tpu_torch.train.loop", "wealy_tpu_torch.train.checkpoint",
            "wealy_tpu_torch.utils.prefetch", "wealy_tpu_torch.ops.layer_norm",
            "wealy_tpu_torch.utils.hostmem", "wealy_tpu_torch.audio.decode",
            "wealy_tpu_torch.audio.resample", "wealy_tpu_torch.cli.extract_batched",
            "wealy_tpu_torch.cli.serve", "wealy_tpu_torch.native",
            "wealy_tpu_torch.data.audio_dataset", "wealy_tpu_torch.data.transcription",
            "wealy_tpu_torch.utils.profiling", "wealy_tpu_torch.models.whisper.quant",
            "wealy_tpu_torch.ops.framing", "wealy_tpu_torch.ops.misc",
            "wealy_tpu_torch.utils.masks", "wealy_tpu_torch.cli.doctor",
            "wealy_tpu_torch.cli.__main__", "wealy_tpu_torch.parallel.mesh",
            "wealy_tpu_torch.parallel.collectives",
            "wealy_tpu_torch.parallel.multihost", "wealy_tpu_torch.parallel.tp",
            "wealy_tpu_torch.parallel.pp", "wealy_tpu_torch.parallel.ring",
            "wealy_tpu_torch.parallel.similarity", "wealy_tpu_torch.graft_entry"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'pandas', 'wealy_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize(
    "pattern",
    [
        r"^\s*(import jax|from jax)",
        r"^\s*(import wealy_tpu\b|from wealy_tpu(\.| ))",
        r"scaled_dot_product_attention",
        r"torch\.compile",
        r"^\s*try:",  # no try around a build or a launch: failures raise
    ],
)
def test_forbidden_patterns_absent(pattern):
    files = sorted(PKG.rglob("*.py"))
    if "attention" not in pattern:
        # chip_smoke.py times the library attention beside K2 and K5; the port never calls it
        files.append(REPO / "chip_smoke.py")
    exempt = PKG / "cli" / "serve.py" if "try" in pattern else None
    hits = [
        f"{p.relative_to(REPO)}:{i}"
        for p in files
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line) and not (p == exempt and line.endswith(ERROR_ANSWER))
    ]
    assert not hits, hits


def test_every_kernel_has_a_source_note():
    for name in ("log_mel.cu", "flash_attention.cu", "flash_attention_bwd.cu", "fused_mlp.cu",
                 "bpwr_redux.cu", "layer_norm.cu"):
        head = (PKG / "csrc" / name).read_text()[:3000]
        assert "Replaces the TPU kernel wealy_tpu/" in head, name
        assert "What bounds it on an H100" in head, name


def _code(name: str) -> str:
    """A kernel source without its comments."""
    src = (PKG / "csrc" / name).read_text()
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def _shared_arrays(code: str, n_structs: int) -> set:
    """The (type, declarator) of every float/bf16 array in the blocks'
    shared-memory structs."""
    bodies = re.findall(r"struct Smem\w* \{(.*?)\};", code, re.S)
    assert len(bodies) == n_structs
    return {m for body in bodies for m in re.findall(r"(float2?|bf16) (\w+\[[^;]*\]);", body)}


def test_hopper_header_holds_the_building_blocks():
    """The mbarrier, TMA, descriptor and wgmma wrappers and the tensor-map
    encoding live once, in csrc/hopper.cuh, for K2, K5a/K5b and K3."""
    code = _code("hopper.cuh")
    assert "wgmma.mma_async" in code and "wgmma.wait_group" in code
    assert "cp.async.bulk.tensor" in code
    assert "mbarrier.try_wait" in code and "mbarrier.arrive.expect_tx" in code
    assert "cuTensorMapEncodeTiled" in code and "__trap()" in code
    for name in ("flash_attention.cu", "flash_attention_bwd.cu", "fused_mlp.cu"):
        kernel = _code(name)
        assert '#include "hopper.cuh"' in kernel, name
        assert "asm volatile" not in kernel and "EncodeTiled" not in kernel, name


def test_attention_backward_is_the_hopper_design():
    """K5a/K5b: every product on wgmma, the streamed tiles through a TMA ring
    of at least two stages with mbarriers, and no WMMA left; K5a sums delta
    from p and dp in a first sweep over the key tiles and reads no forward
    output."""
    code = _code("flash_attention_bwd.cu")
    for call in ("wgmma_ss(", "wgmma_rs(", "tma_load(", "mbar_wait(", "mbar_expect_tx("):
        assert call in code, call
    assert int(re.search(r"constexpr int NST = (\d+);", code).group(1)) >= 2
    assert "tile_map(" in code and "__grid_constant__" in code
    assert not re.search(r"\bwmma::|nvcuda|<mma\.h>|mma\.sync", code)
    dq_kernel = code[code.index("flash_bwd_dq_kernel("):code.index("flash_bwd_dkv_kernel(")]
    assert "2 * n_tiles" in dq_kernel and "out" not in re.findall(r"\w+", dq_kernel.split("{")[0])
    # nothing of S, dP, p or ds has a place in shared memory: the blocks'
    # shared arrays are the bf16 input tiles, the staged bf16 outputs and
    # per-row lse/delta
    arrays = _shared_arrays(code, 2)
    assert {a for t, a in arrays if t == "float"} <= {"lse[NST][BT]", "delta[NST][BT]"}
    assert all(a.endswith("[TILE]") or a.endswith("[BT * LDO]") for t, a in arrays if t == "bf16")


def test_attention_forward_is_the_hopper_design():
    """K2: S = Q.K^T and O += P.V on wgmma (P from registers), K/V through a
    TMA ring of at least two stages with mbarriers and a producer warp, no
    WMMA, and S, P and O never in shared memory (only the input tiles and
    the staged bf16 output are)."""
    code = _code("flash_attention.cu")
    assert "wgmma_ss(" in code and "wgmma_rs(" in code
    assert "tma_load(" in code and "mbar_wait(" in code and "mbar_arrive(" in code
    assert int(re.search(r"constexpr int NST = (\d+);", code).group(1)) >= 2
    assert "__grid_constant__ CUtensorMap" in code
    assert not re.search(r"\bwmma::|nvcuda|<mma\.h>|mma\.sync", code)
    assert code.count("__syncthreads") == 1  # after the barriers' init, none in the loop
    arrays = _shared_arrays(code, 1)
    assert not {a for t, a in arrays if t.startswith("float")}
    assert all(a.endswith("[TILE]") or a.endswith("[BT * LDO]") for t, a in arrays)


def test_mlp_is_the_hopper_design():
    """K3: both GEMMs on m64n128k16 wgmma with both operands in shared memory,
    fed by a TMA ring of at least three stages from 2-D tensor maps (cached on
    the host) by a producer warp, two consumer warpgroups, no WMMA."""
    code = _code("fused_mlp.cu")
    for call in ("wgmma_ss128(", "tma_load_2d(", "mbar_wait(", "mbar_expect_tx(", "mbar_arrive(",
                 "cached_map(", "erff("):
        assert call in code, call
    assert min(int(n) for n in re.findall(r"NST = GELU \? (\d+) : (\d+);", code)[0]) >= 3
    assert "constexpr int CONSUMERS = 2 * WG;" in code
    assert not re.search(r"\bwmma::|nvcuda|<mma\.h>|mma\.sync", code)
    assert "m64n128k16" in _code("hopper.cuh") and "tensor.2d" in _code("hopper.cuh")


def test_bpwr_takes_every_tile_size():
    """K4: no side limit in the C entry or the wrapper; the sorted route
    keeps rows as lanes with bitmask column liveness ORed across the lanes
    and sorts each row once, the block route reads the tile from device
    memory where it does not fit in shared memory, and one function picks
    the route for the launch and for ``kernel_route``."""
    code = _code("bpwr_redux.cu")
    entry = code[code.index("WEALY_API int wealy_bpwr_redux("):]
    assert "kMaxSide" not in code and "> 128" not in entry
    for needle in ("__reduce_or_sync(", "__reduce_min_sync(", "sort_row<CMAX>(", "in_smem ?",
                   "cudaDevAttrMaxSharedMemoryPerBlockOptin", "bpwr_sorted_kernel<L, CMAX>",
                   "bpwr_block_kernel<<<"):
        assert needle in code, needle
    assert code.count("cudaDevAttrMaxSharedMemoryPerBlockOptin") == 1
    assert entry.count("pick_route(") == 2  # the launch and wealy_bpwr_route
    assert "atomic" not in code  # a fixed order of adds: bit-equal and repeatable
    wrapper = (PKG / "ops" / "bpwr_redux.py").read_text()
    assert "MAX_SIDE" not in wrapper


def test_log_mel_is_the_fft_route():
    """K1: no dense (400, 201) DFT basis; an FFT plan (radix-8 and radix-5
    stages, the real split) and the mel product over each band's bins."""
    code = _code("log_mel.cu")
    assert "wcos" not in code and "wsin" not in code
    assert "dft8(" in code and "dft5<" in code and "PLAN_SPLIT" in code
    assert "band_w" in code and "count" in code
    assert "tf32" not in code.lower() and "wmma" not in code and "mma" not in code
    sig = _build.SIGNATURES["wealy_log_mel"]
    assert len(sig) == 11  # audio, plan, band, band_w, out, 5 ints, stream


def test_cpu_path_counts_no_launches():
    counters = (log_mel_spectrogram_fused, flash_mha, flash_mha_bwd_dq, flash_mha_bwd_dkv,
                fused_mlp, bpwr_block_redux, fused_layer_norm)
    before = [f.launches for f in counters]
    rng = np.random.default_rng(0)
    log_mel_spectrogram_fused(torch.from_numpy(rng.normal(size=N_SAMPLES).astype(np.float32)))
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(np.float32)).bfloat16()
    q.requires_grad_(True)
    flash_mha(q, q, q, 0.125).float().sum().backward()
    x = torch.zeros(3, 64, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros(256, 64, dtype=torch.bfloat16)
    fused_mlp(x, w, torch.zeros(256), w.T.contiguous(), torch.zeros(64)).float().sum().backward()
    assert q.grad is not None and x.grad is not None
    d = torch.from_numpy(rng.uniform(size=(2, 3, 4, 5)).astype(np.float32))
    bpwr_block_redux(d, torch.ones(2, 4, dtype=torch.bool), torch.ones(3, 5, dtype=torch.bool))
    y = torch.zeros(2, 8, requires_grad=True)
    fused_layer_norm(y, torch.ones(8), torch.zeros(8)).sum().backward()
    assert y.grad is not None
    assert [f.launches for f in counters] == before


def test_non_cuda_device_raises():
    before = (flash_mha.launches, log_mel_spectrogram_fused.launches, bpwr_block_redux.launches,
              flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches, fused_layer_norm.launches)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="flash_mha"):
        flash_mha(q, q, q, 0.125)
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="flash_mha_bwd_dq"):
        flash_mha_bwd_dq(q, q, q, q, lse, 0.125)
    with pytest.raises(ValueError, match="flash_mha_bwd_dkv"):
        flash_mha_bwd_dkv(q, q, q, q, lse, lse, 0.125)
    with pytest.raises(ValueError, match="log_mel"):
        log_mel_spectrogram_fused(torch.zeros(N_SAMPLES, device="meta"))
    valid = torch.ones(1, 2, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="bpwr_block_redux"):
        bpwr_block_redux(torch.zeros(1, 1, 2, 2, device="meta"), valid, valid)
    with pytest.raises(ValueError, match="fused_layer_norm"):
        fused_layer_norm(torch.zeros(2, 8, device="meta"), torch.ones(8), torch.zeros(8))
    assert (flash_mha.launches, log_mel_spectrogram_fused.launches, bpwr_block_redux.launches,
            flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches,
            fused_layer_norm.launches) == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_flags_and_source_hash():
    assert _build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    names = {p.name for p in _build.sources()}
    assert {"log_mel.cu", "flash_attention.cu", "flash_attention_bwd.cu", "fused_mlp.cu",
            "bpwr_redux.cu", "layer_norm.cu", "common.cuh", "hopper.cuh"} <= names
    assert set(_build.SIGNATURES) == {"wealy_log_mel", "wealy_flash_mha_fwd",
                                      "wealy_flash_mha_bwd_dq", "wealy_flash_mha_bwd_dkv",
                                      "wealy_fused_mlp", "wealy_bpwr_redux", "wealy_bpwr_route",
                                      "wealy_layer_norm"}
    assert "-shared" not in _build.NVCC_FLAGS  # one object per source, linked after
    key = _build._source_hash()
    assert len(key) == 16 and key == _build._source_hash()


@pytest.mark.parametrize("command", [
    ["train"], ["evaluate", "--split", "test"], ["extract", "--split", "test", "--batched"],
    ["index", "--out", "idx.npz"],
    ["query", "--index", "idx.npz", "--query-embeddings", "q.npz"], ["serve", "--index", "idx.npz"],
])
def test_entry_points_refuse_cpu_unless_asked(tmp_path, command):
    """Without a card and without ``--device cpu`` a command exits nonzero
    with the no-card message before it does any work, and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run on it")
    conf = tmp_path / "conf.json"
    conf.write_text('{"model": {"name": "whisper", "zdim": 16}}')
    proc = subprocess.run(
        [sys.executable, "-m", "wealy_tpu_torch.cli.main", command[0], "--config", str(conf),
         *command[1:]], cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert wealy_tpu_torch.NO_CARD in proc.stderr
    assert proc.stdout == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wealy_tpu_torch.default_device()
    assert wealy_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_hostmem_pins_on_glibc_and_is_a_noop_elsewhere(monkeypatch):
    import platform

    from wealy_tpu_torch.utils import hostmem

    if platform.libc_ver()[0] == "glibc":
        assert hostmem.pin_malloc_thresholds() is True
    assert isinstance(hostmem.trim_host_heap(), bool)
    monkeypatch.setattr(hostmem, "_libc", None)
    monkeypatch.setattr(hostmem.platform, "libc_ver", lambda: ("musl", ""))
    assert hostmem.pin_malloc_thresholds() is False
    assert hostmem.trim_host_heap() is False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(tmp_path, alone):
    """Without CUDA (and, alone, without the rest of the repo) the script
    exits nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    cwd = REPO
    env = dict(os.environ)
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
