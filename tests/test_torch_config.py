"""The port's default config (``tpu3dlm_torch/utils/config.py``) against the
file ``tpu3dlm.utils.config.write_default_config`` writes: the same
sections, keys and values, read through ``configparser`` on both sides (the
comments may differ)."""

import configparser

from tpu3dlm.utils.config import write_default_config as j_write
from tpu3dlm_torch.utils.config import DEFAULT_CONFIG, write_default_config


def _read(text: str) -> dict:
    cp = configparser.ConfigParser()
    cp.read_string(text)
    return {s: dict(cp[s]) for s in cp.sections()} | {"DEFAULT": dict(cp.defaults())}


def test_default_config_equals_the_reference_key_for_key(tmp_path):
    j_write(str(tmp_path / "jax.cfg"))
    write_default_config(str(tmp_path / "port.cfg"))
    want = _read((tmp_path / "jax.cfg").read_text())
    assert _read(DEFAULT_CONFIG) == want
    assert _read((tmp_path / "port.cfg").read_text()) == want
    assert "not ported yet" not in DEFAULT_CONFIG
