"""Training (port of ``training/``): the causal-LM loss, full-parameter and
LoRA train steps with AdamW, and the export of a trained adapter slot to
the ``.npz`` form that the serving stack loads (``server/lora_manager``)."""
