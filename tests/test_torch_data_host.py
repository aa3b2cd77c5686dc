"""The port's host data layer against the JAX package's (CPU).

preprocess manifests, the native C++ wav decoder (the port's own build of
native/wavloader.cpp), AudioDataset with the native decoder on and off,
SPHERE reading and conversion (native/sphio.cpp, on tests/shorten_encoder.py
streams) and mixture creation: the same inputs through both packages give
the same bytes. Decoded samples: native = JAX native = wavio exactly for
FLOAT wavs, within 1e-6 for PCM_16 (the codecs' own gate,
tests/test_native_loader.py). Native decoding runs wherever g++ builds the
library, as in tests/test_native_loader.py."""

import hashlib
import json
import os

import numpy as np
import pytest

from convtasnet_torch.cli import preprocess as t_pre
from convtasnet_torch.data import dataset as t_ds
from convtasnet_torch.data import mixtures as t_mix
from convtasnet_torch.data import native_loader as t_native
from convtasnet_torch.data import sphio as t_sph
from convtasnet_torch.data._native import BUILD_DIR
from convtasnet_torch.data.manifest import preprocess
from convtasnet_torch.data.synthetic import make_wav_dataset
from convtasnet_torch.data.wavio import read_wav, write_wav
from convtasnet_tpu.cli import preprocess as j_pre
from convtasnet_tpu.data import dataset as j_ds
from convtasnet_tpu.data import mixtures as j_mix
from convtasnet_tpu.data import native_loader as j_native
from convtasnet_tpu.data import sphio as j_sph

from shorten_encoder import write_sphere_pcm, write_sphere_shorten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_native(mod):
    if not mod.available():
        pytest.skip("no C++ toolchain for the native wav decoder")


def _tracked_so_digests():
    out = {}
    for name in ("libwavloader.so", "libsphio.so"):
        with open(os.path.join(REPO, "native", name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    json_root = make_wav_dataset(str(d), n_utts=4, min_sec=0.6, max_sec=1.4, seed=9,
                                 splits=("tr", "cv", "tt"))
    return str(d / "wav"), json_root


def test_preprocess_cli_matches_jax(wav_tree, tmp_path):
    wav_root, _ = wav_tree
    for main, out in ((t_pre.main, tmp_path / "t"), (j_pre.main, tmp_path / "j")):
        main(["--in-dir", wav_root, "--out-dir", str(out), "--num-speakers", "2"])
    for split in ("tr", "cv", "tt"):
        for spk in ("mix", "s1", "s2"):
            got = (tmp_path / "t" / split / f"{spk}.json").read_bytes()
            assert got == (tmp_path / "j" / split / f"{spk}.json").read_bytes()
            assert len(json.loads(got)) == 4


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_native_decode_matches_jax_and_wavio(tmp_path, subtype):
    _need_native(t_native)
    jax_native = j_native.available()  # the JAX package may rebuild its own .so first
    before = _tracked_so_digests()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"x{i}.wav")
        write_wav(p, rng.uniform(-0.9, 0.9, 700 + 90 * i).astype(np.float32), 8000, subtype)
        paths.append(p)
    buf, lens, rates = t_native.decode_batch(paths, 1200, n_threads=3)
    assert os.path.dirname(t_native.get_lib()._name) == BUILD_DIR
    assert (rates == 8000).all()
    if jax_native:
        jbuf, jlens, jrates = j_native.decode_batch(paths, 1200, n_threads=3)
        np.testing.assert_array_equal(buf, jbuf)
        np.testing.assert_array_equal(lens, jlens)
        np.testing.assert_array_equal(rates, jrates)
    for i, p in enumerate(paths):
        want, _ = read_wav(p)
        assert lens[i] == want.size
        if subtype == "FLOAT":
            np.testing.assert_array_equal(buf[i, :lens[i]], want)
        else:
            np.testing.assert_allclose(buf[i, :lens[i]], want, atol=1e-6)
    assert _tracked_so_digests() == before


def test_native_decode_reports_bad_file(tmp_path):
    _need_native(t_native)
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"not a wav file at all, just bytes")
    with pytest.raises(RuntimeError, match="decode failed"):
        t_native.decode_batch([p], 100)


@pytest.mark.parametrize("segment", [1.0, -1])
def test_dataset_native_on_off_and_jax(wav_tree, segment):
    """AudioDataset batches with the native decoder, with wavio alone and
    from the JAX AudioDataset are equal; the counters say which decoder
    decoded each file."""
    _, json_root = wav_tree
    d = os.path.join(json_root, "tr")
    ds = t_ds.AudioDataset(d, batch_size=3, segment=segment)
    jds = j_ds.AudioDataset(d, batch_size=3, segment=segment)
    assert len(ds) == len(jds) > 0
    native = t_native.available()
    for i in range(len(ds)):
        n_files = 3 * len(ds.batches[i])
        t_ds.reset_counts()
        a = ds.load_batch(i)
        assert t_ds.counts() == ({"native": n_files, "wavio": 0} if native
                                 else {"native": 0, "wavio": n_files})
        ds.disable_native = True
        t_ds.reset_counts()
        b = ds.load_batch(i)
        ds.disable_native = False
        assert t_ds.counts() == {"native": 0, "wavio": n_files}
        j = jds.load_batch(i)
        for x in (b, j):
            np.testing.assert_array_equal(a.lengths, x.lengths)
            np.testing.assert_allclose(a.mixture, x.mixture, atol=1e-6, rtol=0)
            np.testing.assert_allclose(a.source, x.source, atol=1e-6, rtol=0)


def test_dataset_resamples_other_rate_through_wavio(tmp_path):
    """A file at another rate goes through wavio (which resamples), as in
    the JAX package; the rest of the batch stays native."""
    root = tmp_path / "wav"
    rng = np.random.default_rng(1)
    for spk in ("mix", "s1", "s2"):
        os.makedirs(root / "tt" / spk)
        write_wav(str(root / "tt" / spk / "a.wav"), rng.uniform(-.5, .5, 1600), 16000,
                  "FLOAT")
        write_wav(str(root / "tt" / spk / "b.wav"), rng.uniform(-.5, .5, 900), 8000,
                  "FLOAT")
    preprocess(str(root), str(tmp_path / "json"), splits=("tt",))
    ds = t_ds.AudioDataset(str(tmp_path / "json" / "tt"), batch_size=2, segment=-1)
    jds = j_ds.AudioDataset(str(tmp_path / "json" / "tt"), batch_size=2, segment=-1)
    t_ds.reset_counts()
    got, want = ds.load_batch(0), jds.load_batch(0)
    if t_native.available():
        assert t_ds.counts() == {"native": 3, "wavio": 3}
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.mixture, want.mixture, atol=1e-6, rtol=0)


def _sphere_files(tmp_path):
    rng = np.random.default_rng(4)
    t = np.arange(3000)[:, None]
    x = np.clip(np.round(3000 * np.sin(2 * np.pi * 0.01 * t) + rng.normal(0, 80, (3000, 2))),
                -32000, 32000).astype(np.int64)
    src = tmp_path / "sph"
    os.makedirs(src / "spk1")
    files = {
        "spk1/a.wv1": lambda p: write_sphere_shorten(p, x[:, 0], 16000),
        "spk1/b.wv1": lambda p: write_sphere_shorten(p, x, 16000),
        "c.sph": lambda p: write_sphere_pcm(p, x[:, 0].astype(np.int16), 8000),
    }
    for name, write in files.items():
        write(str(src / name))
    return src, list(files)


def test_sphere_read_and_convert_match_jax(tmp_path):
    src, names = _sphere_files(tmp_path)
    if not t_sph.native_available():
        names = [n for n in names if n.endswith(".sph")]  # shorten needs the native decoder
    for name in names:
        p = str(src / name)
        got, sr = t_sph.read_sphere(p)
        want, jsr = j_sph.read_sphere(p)
        assert sr == jsr and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert t_sph.sphere_info(p) == j_sph.sphere_info(p)
    if t_sph.native_available():
        assert os.path.dirname(t_sph._get_lib()._name) == BUILD_DIR
        out_t = t_sph.convert_sphere_dir(str(src), str(tmp_path / "t"), n_threads=2)
        out_j = j_sph.convert_sphere_dir(str(src), str(tmp_path / "j"), n_threads=2)
        assert [os.path.relpath(p, tmp_path / "t") for p in out_t] == [
            os.path.relpath(p, tmp_path / "j") for p in out_j]
        for a, b in zip(out_t, out_j):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
    np.testing.assert_array_equal(t_sph._decode_py(str(src / "c.sph")),
                                  j_sph._decode_py(str(src / "c.sph")))


def test_create_mixtures_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    for spk in ("spkA", "spkB", "spkC"):
        os.makedirs(tmp_path / "src" / spk)
        for u in range(2):
            n = int(rng.uniform(0.4, 0.8) * 8000)
            sig = np.sin(2 * np.pi * rng.uniform(100, 400) * np.arange(n) / 8000)
            sig = sig * (np.arange(n) % 2000 < 1400) + 0.01 * rng.standard_normal(n)
            write_wav(str(tmp_path / "src" / spk / f"u{u}.wav"), 0.3 * sig, 8000)
    dirs = [str(tmp_path / "src")]
    pairs = t_mix.random_pair_list(dirs, n_mixtures=3, seed=11)
    assert pairs == j_mix.random_pair_list(dirs, n_mixtures=3, seed=11)
    for mode in ("min", "max"):
        meta_t = t_mix.create_mixtures(pairs, str(tmp_path / f"t_{mode}"), mode=mode)
        meta_j = j_mix.create_mixtures(pairs, str(tmp_path / f"j_{mode}"), mode=mode)
        assert meta_t == meta_j
        for m in meta_t:
            for sub in ("mix", "s1", "s2"):
                a = tmp_path / f"t_{mode}" / sub / (m["name"] + ".wav")
                b = tmp_path / f"j_{mode}" / sub / (m["name"] + ".wav")
                assert a.read_bytes() == b.read_bytes()
    x = np.random.default_rng(3).standard_normal(4000)
    assert t_mix.active_speech_level_p56(x) == j_mix.active_speech_level_p56(x)
