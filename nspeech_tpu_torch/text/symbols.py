"""Input symbol inventory.

This table is a frozen contract — it defines the embedding vocabulary and
therefore checkpoint compatibility. Ordering and contents match the reference
(reference: neural_speech/utils/text/symbols.py:9-17): pad, eos, 63 ASCII
characters, then the 84 ARPAbet phones prefixed with '@' for uniqueness.
"""

from nspeech_tpu_torch.text.cmudict import VALID_SYMBOLS

PAD = "_"
EOS = "~"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "

_arpabet = ["@" + s for s in VALID_SYMBOLS]

symbols = [PAD, EOS] + list(_characters) + _arpabet

PAD_ID = symbols.index(PAD)  # 0 — padding id contract (reference: datafeeder.py:17)
EOS_ID = symbols.index(EOS)  # 1
