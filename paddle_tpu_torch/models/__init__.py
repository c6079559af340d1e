"""Model builders of the port: the static BERT builders, the dygraph BERT
/ ERNIE pretraining models (models/bert.py) and the dygraph GPT
(models/gpt.py)."""
from .bert_static import build_bert_base, build_bert_pretrain  # noqa: F401
from .bert import (  # noqa: F401
    BertConfig, BertModel, BertForPretraining, BertPretrainingCriterion,
    ErnieModel, ErnieForPretraining, bert_base, bert_large, ernie_base,
)
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForGeneration, gpt_small,
)
