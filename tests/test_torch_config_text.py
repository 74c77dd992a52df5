"""The port's config and text frontend against the JAX package's.

The hparam tables must equal the parsed YAML files exactly, and
``text_to_sequence`` must give the same ids for the same text."""

import jax  # noqa: F401  (both frameworks in one process, as in every port test)
import pytest
import torch

from nspeech_tpu import config as jcfg
from nspeech_tpu.data.feeder import round_up as j_round_up
from nspeech_tpu.text import symbols as jsymbols
from nspeech_tpu.text import text_to_sequence as j_text2seq
from nspeech_tpu_torch import config as tcfg
from nspeech_tpu_torch.data.feeder import round_up as t_round_up
from nspeech_tpu_torch.text import symbols as tsymbols
from nspeech_tpu_torch.text import text_to_sequence as t_text2seq

torch.set_num_threads(1)


@pytest.mark.parametrize("model", ["taco2", "wavenet", "simple_wavenet"])
def test_hparams_equal_yaml(model):
    assert tcfg.load_config(model).values() == jcfg.load_config(model).values()


def test_config_parse_and_stft_params():
    t = tcfg.load_config("taco2").parse("max_iters=7,cleaners=basic_cleaners")
    j = jcfg.load_config("taco2").parse("max_iters=7,cleaners=basic_cleaners")
    assert t.values() == j.values()
    assert tcfg.stft_params(t) == jcfg.stft_params(j) == (2048, 250, 1000)
    with pytest.raises(ValueError):
        t.parse("no_such_key=1")
    # loading twice gives independent nested values
    a, b = tcfg.load_config("taco2"), tcfg.load_config("taco2")
    a.adam["beta1"] = 0.5
    assert b.adam["beta1"] == 0.9


TEXTS = [
    "Hello, World!",
    "Mr. Smith paid $3.50 on the 21st of March, 1984.",
    "Turn left on {HH AW1 S} street {AE1 T} 10:30.",
    "Crème brûlée — naïve “quotes”… and £100,000.",
    "  lots   of\twhitespace\n",
    "Dr. Who's 2nd co. vs. Gen. Lee in 2007?",
]


@pytest.mark.parametrize("text", TEXTS)
def test_text_to_sequence_matches(text):
    for cleaners in (["english_cleaners"], ["basic_cleaners"],
                     ["transliteration_cleaners"]):
        assert t_text2seq(text, cleaners) == j_text2seq(text, cleaners)


def test_symbols_and_padding_helpers():
    from nspeech_tpu.text.symbols import EOS_ID as j_eos, PAD_ID as j_pad
    from nspeech_tpu_torch.text.symbols import EOS_ID as t_eos, PAD_ID as t_pad

    assert tsymbols == jsymbols
    assert t_pad == j_pad == 0
    assert t_eos == j_eos
    for x, m in [(0, 32), (1, 32), (32, 32), (33, 32), (70, 16)]:
        assert t_round_up(x, m) == j_round_up(x, m)
