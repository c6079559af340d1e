"""Model builders of the port."""
from .bert_static import build_bert_base, build_bert_pretrain  # noqa: F401
