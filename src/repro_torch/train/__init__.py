"""Training: AdamW with float32, bfloat16 or int8 state (``optim``) and
the train step with accumulation and the compressed pod all-reduce
(``step``)."""
