"""The port's AOJ reader and dataset helpers against the JAX package's on
the same synthetic files and the same numpy seeds: equal arrays (exact for
integers, 1e-6 for floats) and equal metadata, for every transform, feature
selection and padding mode; `standardize`, `pt_order`, `jet_set_to_seq`,
`seq_to_jet_set`; the empirical pad masks; the train / val split."""

import numpy as np
import pytest
import torch

from multimodal_flows_tpu.data import aoj as jaoj
from multimodal_flows_tpu.data import datasets as jdatasets
from multimodal_flows_tpu.data.state import DataCoupling as JaxCoupling
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu_torch.cli.train_mmf import split_jets
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data import aoj, datasets
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.trainer import Trainer
from tests.conftest import make_jets
from tests.test_aoj import write_real_schema_aoj, write_synthetic_aoj

FLOAT_ATOL = 1e-6


def _equal(ours: MultiModal, theirs: JaxMultiModal):
    for field in ("time", "continuous", "discrete", "mask"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_ATOL, err_msg=field)


def _equal_metadata(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if isinstance(want, int):
            assert type(ours[key]) is int and ours[key] == want, key
        else:
            assert all(type(v) is float for v in ours[key]), key   # yaml-safe numbers
            np.testing.assert_allclose(ours[key], want, rtol=0, atol=FLOAT_ATOL, err_msg=key)


@pytest.fixture(scope="module")
def aoj_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("aoj")
    write_synthetic_aoj(str(d / "RunG_a.h5"), num_jets=40, max_p=12, seed=0)
    write_synthetic_aoj(str(d / "RunG_b.h5"), num_jets=30, max_p=12, seed=1)
    write_real_schema_aoj(str(d / "RunG_zoo.h5"), pid_zoo=True, presorted=False, seed=11)
    return str(d)


CALLS = {
    "defaults": dict(max_num_particles=10),
    "standardize": dict(max_num_particles=10, transform="standardize"),
    "normalize": dict(max_num_particles=12, transform="normalize"),
    "log_pt": dict(max_num_particles=12, transform="log_pt"),
    "num_jets_cap": dict(num_jets=17, max_num_particles=8, transform="standardize"),
    "impact_parameters": dict(max_num_particles=12, features={
        "continuous": ["pt", "d0", "d0Err", "dz", "dzErr", "px", "py", "pz", "e", "eta", "phi"],
        "discrete": "tokens"}),
    "onehot": dict(max_num_particles=8, features={"continuous": ["pt"], "discrete": "onehot"}),
    "tokens_only": dict(max_num_particles=8, features={"continuous": [], "discrete": "tokens"}),
    "ghosts": dict(max_num_particles=12, padding="ghosts", seed=3),
    "shuffled_slots": dict(max_num_particles=12, pt_order=False, seed=5),
}


@pytest.mark.parametrize("files", ["RunG_a.h5", ["RunG_a.h5", "RunG_b.h5"], "RunG_zoo.h5"],
                         ids=["one_file", "two_files", "pid_zoo_unsorted"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_reader_gives_the_jax_packages_arrays_and_metadata(aoj_dir, files, call):
    kw = CALLS[call]
    ours, meta = aoj.AspenOpenJets(aoj_dir, files)(**kw)
    theirs, jmeta = jaoj.AspenOpenJets(aoj_dir, files)(**kw)
    assert all(isinstance(v, np.ndarray) for v in (ours.continuous, ours.discrete, ours.mask)
               if v is not None)
    _equal(ours, theirs)
    _equal_metadata(meta, jmeta)
    assert len(ours) == (17 if call == "num_jets_cap" else len(theirs))


def test_reader_errors_and_the_download_gate(aoj_dir, tmp_path, monkeypatch):
    """A missing file raises; with `download` the reader asks `_download_file`
    for it (never run here: nothing is fetched in a test); an unreadable
    file raises ValueError; `load_metadata` reads `metadata.json`."""
    with pytest.raises(FileNotFoundError, match="RunG_missing.h5"):
        aoj.AspenOpenJets(aoj_dir, "RunG_missing.h5")()
    asked = []
    monkeypatch.setattr(aoj.AspenOpenJets, "_download_file",
                        lambda self, target: asked.append(target))
    with pytest.raises(FileNotFoundError):
        aoj.AspenOpenJets(aoj_dir, "RunG_missing.h5")(download=True)
    assert asked == [f"{aoj_dir}/RunG_missing.h5"]
    (tmp_path / "RunG_bad.h5").write_bytes(b"not hdf5")
    with pytest.raises(ValueError, match="error reading file"):
        aoj.AspenOpenJets(str(tmp_path), "RunG_bad.h5")()
    (tmp_path / "metadata.json").write_text('{"mean": [1.0]}')
    assert aoj.AspenOpenJets(str(tmp_path)).load_metadata(str(tmp_path)) == {"mean": [1.0]}
    assert aoj.AOJ_URL == jaoj.AOJ_URL and aoj.PID_TO_TOKEN == jaoj.PID_TO_TOKEN


def test_pure_helpers_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    pf = rng.normal(size=(6, 9, 10)).astype(np.float32) * 30
    pf[..., -2] = rng.choice([22, 130, -211, 211, -11, 11, -13, 13, 1, 2, 3122, 0], size=(6, 9))
    np.testing.assert_array_equal(aoj.filter_particles(pf), jaoj.filter_particles(pf))
    np.testing.assert_array_equal(aoj.pt_sort(pf), jaoj.pt_sort(pf))
    np.testing.assert_array_equal(aoj.map_pid_to_tokens(pf[..., -2]),
                                  jaoj.map_pid_to_tokens(pf[..., -2]))
    dphi = rng.uniform(-10, 10, size=100)
    np.testing.assert_array_equal(aoj.wrap_phi(dphi), jaoj.wrap_phi(dphi))
    jets = make_jets(B=20, D=9, seed=1)
    _equal_metadata(aoj.extract_metadata(np.abs(jets.continuous) + 0.1, jets.mask),
                    jaoj.extract_metadata(np.abs(jets.continuous) + 0.1, jets.mask))
    assert set(aoj.extract_metadata(None, jets.mask)) == {
        "num_jets_sample", "num_particles_sample", "max_num_particles_per_jet"}
    np.testing.assert_array_equal(aoj.multiplicity_histogram(jets.mask, 9),
                                  jaoj.multiplicity_histogram(jets.mask, 9))


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_empirical_masks_are_the_same_arrays(seed, randomize):
    """The generation pad masks come from a numpy seed: both packages draw
    the same array, not merely the same law; the port also takes tensors."""
    masks = make_jets(B=300, D=30, seed=4, min_particles=3).mask
    kw = dict(num_jets=500, max_num_particles=30, randomize_masks=randomize, seed=seed)
    ours = aoj.sample_from_empirical_masks(masks, **kw)
    theirs = jaoj.sample_from_empirical_masks(masks, **kw)
    assert ours.dtype == theirs.dtype == np.int64 and ours.shape == (500, 30, 1)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        aoj.sample_from_empirical_masks(torch.from_numpy(masks), **kw), theirs)


def _both(jets):
    return (MultiModal(continuous=jets.continuous, discrete=jets.discrete, mask=jets.mask),
            jets)


def test_standardize_and_pt_order_equal_the_jax_packages():
    ours, theirs = _both(make_jets(B=9, D=11, seed=2))
    out, stats = datasets.standardize(ours)
    jout, jstats = jdatasets.standardize(theirs)
    _equal(out, jout)
    assert stats == jstats
    for include_mask in (False, True):
        _equal(datasets.pt_order(ours, include_mask), jdatasets.pt_order(theirs, include_mask))
    # tensors in, numpy out; a state without kinematics is refused
    as_tensors = ours.map(torch.as_tensor)
    _equal(datasets.pt_order(as_tensors, True), jdatasets.pt_order(theirs, True))
    with pytest.raises(ValueError, match="continuous"):
        datasets.pt_order(MultiModal(discrete=ours.discrete, mask=ours.mask))


@pytest.mark.parametrize("ndim", [3, 2])
def test_set_to_sequence_round_trip_equals_the_jax_packages(ndim):
    """BOS / EOS / PAD sequences for the autoregressive baseline, from
    (N, D, 1) and (N, D) tokens, and back to padded sets."""
    jets = make_jets(B=14, D=9, seed=6, min_particles=1)
    tokens = jets.discrete if ndim == 3 else jets.discrete[..., 0]
    ours = datasets.jet_set_to_seq(MultiModal(discrete=tokens, mask=jets.mask), 9)
    theirs = jdatasets.jet_set_to_seq(JaxMultiModal(discrete=tokens, mask=jets.mask), 9)
    _equal(ours, theirs)
    assert ours.discrete.shape == (14, 11) and (ours.discrete[:, 0] == 10).all()
    assert ((ours.discrete == 11).sum(axis=1) == 1).all()           # one EOS a jet
    for width in (9, 6, 12):
        back = datasets.seq_to_jet_set(ours.discrete, 9, width)
        np.testing.assert_array_equal(back, jdatasets.seq_to_jet_set(theirs.discrete, 9, width))
    np.testing.assert_array_equal(datasets.seq_to_jet_set(ours.discrete, 9, 9),
                                  jets.discrete[..., 0])
    with pytest.raises(ValueError, match="discrete"):
        datasets.jet_set_to_seq(MultiModal(mask=jets.mask), 9)


def test_training_split_is_the_jax_scripts_and_packs(aoj_dir):
    """`split_jets` of the training entry point: the mask-only source and
    the permutation of `default_rng(seed)`, the JAX script's arrays; the
    trainer packs such a coupling and buckets it."""
    ours, meta = aoj.AspenOpenJets(aoj_dir, ["RunG_a.h5", "RunG_b.h5"])(
        max_num_particles=12, transform="standardize")
    theirs, _ = jaoj.AspenOpenJets(aoj_dir, ["RunG_a.h5", "RunG_b.h5"])(
        max_num_particles=12, transform="standardize")
    cfg = Config(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
                 n_head=2, max_num_particles=12, batch_size=8, train_frac=0.8, seed=3,
                 packed_training=True, pack_width=16, metadata=meta)
    train_ds, val_ds = split_jets(ours, cfg)
    jtrain, jval = jdatasets.ArrayDataset(JaxCoupling(
        source=JaxMultiModal(mask=theirs.mask), target=theirs)).split(0.8, seed=3)
    assert (len(train_ds), len(val_ds)) == (len(jtrain), len(jval)) == (56, 14)
    for a, b in ((train_ds, jtrain), (val_ds, jval)):
        _equal(a.coupling.target, b.coupling.target)
        _equal(a.coupling.source, b.coupling.source)
        assert a.coupling.has_source and not a.coupling.has_context

    trainer = Trainer(systems.build_system(cfg, "MMF", device="cpu"), cfg)
    units = trainer._pack_units(train_ds)
    assert units is not None and sum(int(u.coupling.jet_valid.sum()) for u in units) == 56
    buckets = trainer._bucketize(train_ds)
    assert buckets is not None and sum(len(b) for _, b, _ in buckets) == 56
