"""The model families: the decoder (``transformer``: the gated llama /
minerva / mixtral family and the GPT-2 family with GELU, LayerNorm,
learned positions and a tied head), the ViT encoders (``vit``), their
layers, the MoE expert layers, the bench train step and the SPMD
step."""
