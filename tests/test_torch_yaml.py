"""The port's YAML subset reader and writer (``poem_v2_tpu_torch/utils/config.py``)
against PyYAML: every YAML file of the repository parses to what ``safe_load``
gives, text outside the subset raises with its line number, and what the
writer writes both read back unchanged."""

import glob
import math
import os

import numpy as np
import pytest

from poem_v2_tpu_torch.configs import RELEASE, SYNTHETIC
from poem_v2_tpu_torch.utils import config
from poem_v2_tpu_torch.utils.config import YAMLSubsetError, dump_yaml, parse_yaml

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, ROOT) for p in (
    glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
    + glob.glob(os.path.join(ROOT, "configs", "release", "*.yaml"))
    + glob.glob(os.path.join(ROOT, "exp_records", "*", "dump_cfg*.yaml"))))


def test_every_yaml_file_is_found():
    assert len([f for f in FILES if f.startswith("configs")]) == 12
    assert len([f for f in FILES if f.startswith("exp_records")]) >= 6


@pytest.mark.parametrize("path", FILES)
def test_repository_yaml_parses_as_pyyaml(path):
    text = open(os.path.join(ROOT, path)).read()
    assert parse_yaml(text, path) == yaml.safe_load(text)


def test_dexycb_metadata_parses_as_pyyaml():
    """The shapes of DexYCB's meta.yml / intrinsics / extrinsics / mano.yml as
    PyYAML writes them (tests/test_adapters.py's fixtures), and as typed by hand."""
    rs = np.random.RandomState(0)
    docs = [
        {"serials": ["840412060917", "932122060857"], "num_frames": 72, "extrinsics": "20200702",
         "mano_calib": ["20200709-subject-01"], "mano_sides": ["right"], "ycb_ids": [2, 11]},
        {"color": {"fx": 615.5, "fy": 615.3, "ppx": 320.0, "ppy": 240.25}},
        {"extrinsics": {"840412060917": np.eye(3, 4).flatten().tolist(),
                        "apriltag": (rs.randn(12) * 0.1).tolist()}},
        {"betas": rs.randn(10).tolist()},
        {},
    ]
    for doc in docs:
        for text in (yaml.safe_dump(doc), yaml.safe_dump(doc, sort_keys=False, width=40)):
            assert parse_yaml(text) == yaml.safe_load(text) == doc
    hand = "serials: ['836212060125', \"839512060362\"]  # two\nnum_frames: 72\nnote: 'it''s'\n"
    assert parse_yaml(hand) == yaml.safe_load(hand)
    with pytest.raises(YAMLSubsetError, match="<string>:3: "):
        parse_yaml(hand.replace("'it''s'", "it's: x"))  # PyYAML refuses it too


SCALARS = ["yes", "No", "on", "OFF", "true", "~", "null", "", "1e-4", "1.0e-4", "-.5", "+3",
           "1_000", "0", ".inf", "-.Inf", "0.5", "x: y", "a#b", "it's", "-", "- x", "[x]",
           " pad", "tail ", "#", "'q'", '"q"', "3.", "12:30:00x"]


@pytest.mark.parametrize("value", SCALARS)
def test_scalars_resolve_as_pyyaml(value):
    """A string written by either writer reads back as itself; plain forms resolve
    as PyYAML's safe loader resolves them."""
    for text in (dump_yaml({"k": value}), yaml.safe_dump({"k": value})):
        assert parse_yaml(text) == yaml.safe_load(text) == {"k": value}, text
    plain = f"k: {value}\n"
    try:
        want = yaml.safe_load(plain)
    except yaml.YAMLError:
        want = None
    if want is not None and isinstance(want, dict) and value.strip() and "#" not in value \
            and not value.startswith(("'", '"', "[", "-", " ")) and ": " not in value:
        got = parse_yaml(plain)
        assert got == want or (isinstance(want["k"], float) and math.isnan(want["k"])), plain


@pytest.mark.parametrize("name", sorted(SYNTHETIC) + sorted(RELEASE))
def test_writer_round_trips_the_configs(name):
    cfg = {**SYNTHETIC, **RELEASE}[name]
    text = dump_yaml(cfg)
    assert parse_yaml(text) == yaml.safe_load(text) == cfg
    assert parse_yaml(yaml.safe_dump(cfg, sort_keys=False)) == cfg


def test_nested_lists_and_maps_round_trip():
    doc = {"a": [[1, 2], {"b": [1, [2, {"c": None}]]}, [{"d": [3.5]}], [[[]]], {}],
           "e": [1e-05, 1e20, -0.0, float("inf"), True, None, "012", "2020-01-01"]}
    for text in (dump_yaml(doc), yaml.safe_dump(doc, sort_keys=False)):
        assert parse_yaml(text) == yaml.safe_load(text) == doc


@pytest.mark.parametrize("text,line", [
    ("a: |\n  x\n", 1),                  # block scalar
    ("a: 1\nb: !!str 3\n", 2),           # tag
    ("---\na: 1\n", 1),                  # document marker
    ("a: 1\nb: [1, 2\n", 2),             # flow list across lines
    ("a: {x: 1,\n  y: 2}\n", 1),         # flow mapping across lines
    ("a: 0x1f\n", 1),                    # hexadecimal integer
    ("a: 012\n", 1),                     # octal integer
    ("a: 2001-12-14\n", 1),              # date
    ("a: 1\n  b: 2\n", 2),               # bad indentation
    ("a: 'x\n", 1),                      # quoted scalar across lines
    ("a:\n  b: 1\n c: 2\n", 3),          # dedent to no parent
    ("a: *nothing\n", 1),                # alias of no anchor
    ("x\ny\n", 1),                       # a multi-line plain scalar
    ("a: 1\n\tb: 2\n", 2),               # tab indentation
    ('a: "\\q"\n', 1),                   # unknown escape
])
def test_text_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(YAMLSubsetError, match=f"<string>:{line}: "):
        parse_yaml(text)


@pytest.mark.parametrize("stem", ["synthetic_overfit_gate", "train_medium"])
def test_get_config_without_pyyaml_reads_files_and_knows_the_copies(tmp_path, monkeypatch, stem):
    """Without PyYAML a config file is read by the subset reader; a path that names
    no file but whose stem is a copy in configs.py takes the copy; anything else
    raises."""
    path = os.path.join(ROOT, "configs", "release" if stem.startswith("train_") else "",
                        f"{stem}.yaml")
    with_yaml = config.get_config(path).to_dict()
    monkeypatch.setattr(config, "_yaml", lambda: None)
    assert config.get_config(path).to_dict() == with_yaml
    copy = config.get_config(config.known_configs()[stem]).to_dict()
    assert config.get_config(str(tmp_path / f"{stem}.yaml")).to_dict() == copy
    with pytest.raises(FileNotFoundError, match="names no configuration"):
        config.get_config(str(tmp_path / "mine.yaml"))
    (tmp_path / "mine.yaml").write_text(dump_yaml({"TRAIN": {"EPOCH": 3}}))
    assert config.get_config(str(tmp_path / "mine.yaml")).TRAIN.EPOCH == 3
    # the config a run dumps is YAML either way, and reads back
    dumped = config.get_config(path).dump()
    assert parse_yaml(dumped) == yaml.safe_load(dumped) == with_yaml
