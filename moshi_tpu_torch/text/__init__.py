"""Text tokenizers of the port (a copy of moshi_tpu/text: the port imports
no module of moshi_tpu)."""

from .spm import SentencePieceTokenizer  # noqa: F401
