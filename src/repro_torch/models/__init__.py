"""The model stack of the port: the ssm family (falcon-mamba) and the
dense and vlm families (qwen2, mistral-large, starcoder2, command-r,
pixtral)."""
