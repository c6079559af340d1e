"""Model builders of the port: the static BERT builders, the static
BASELINE programs (models/baseline_static.py: LeNet-5, ResNet-50,
Transformer-big), the static transformer LM with optional tensor
parallelism (models/static_lm.py), the dygraph BERT / ERNIE pretraining models
(models/bert.py), the dygraph GPT (models/gpt.py) and the dygraph
Transformer seq2seq (models/transformer.py)."""
from . import baseline_static  # noqa: F401
from .baseline_static import (  # noqa: F401
    build_lenet, build_resnet50, build_transformer_big,
)
from .bert_static import build_bert_base, build_bert_pretrain  # noqa: F401
from .static_lm import build_transformer_lm  # noqa: F401
from .bert import (  # noqa: F401
    BertConfig, BertModel, BertForPretraining, BertPretrainingCriterion,
    ErnieModel, ErnieForPretraining, bert_base, bert_large, ernie_base,
)
from .transformer import (  # noqa: F401
    TransformerConfig, TransformerModel, CrossEntropyCriterion,
    transformer_base, transformer_big,
)
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForGeneration, gpt_small,
)
