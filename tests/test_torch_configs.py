"""The port's config registry is a field-by-field twin of the reference's.

p2p_llm_chat_tpu_torch keeps its own copy of models/configs.py (it may not
import the JAX package); this pins the copy to the original so a config
added or edited on one side cannot drift from the other.
"""

import dataclasses

import pytest

from p2p_llm_chat_tpu.models import CONFIGS as REF_CONFIGS
from p2p_llm_chat_tpu_torch.models.configs import CONFIGS, get_config


def test_registry_names_match():
    assert sorted(CONFIGS) == sorted(REF_CONFIGS)
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("name", sorted(REF_CONFIGS))
def test_config_fields_match(name):
    ref = dataclasses.asdict(REF_CONFIGS[name])
    got = dataclasses.asdict(get_config(name))
    assert got == ref
    # Derived properties the model code reads.
    for prop in ("q_dim", "kv_dim", "is_moe"):
        assert getattr(get_config(name), prop) == getattr(REF_CONFIGS[name],
                                                          prop)


def test_unknown_config_raises():
    with pytest.raises(KeyError):
        get_config("no-such-model")
