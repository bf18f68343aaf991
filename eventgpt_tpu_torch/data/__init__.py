"""Prompt templating and tokenization."""
from eventgpt_tpu_torch.data.conversation import (  # noqa: F401
    Conversation,
    SeparatorStyle,
    conv_templates,
    default_conversation,
    prepare_event_prompt,
)
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event  # noqa: F401
