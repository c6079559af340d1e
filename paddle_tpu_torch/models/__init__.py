"""Model builders of the port: the static BERT builders and the dygraph
GPT (models/gpt.py)."""
from .bert_static import build_bert_base, build_bert_pretrain  # noqa: F401
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForGeneration, gpt_small,
)
