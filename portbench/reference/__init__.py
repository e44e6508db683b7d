"""The benchmark's plain reference: float32 PyTorch and NumPy, independent of
the program under test (``torch_ref``: UNet3D, AutoencoderKL decoder, DDIM;
``clip_text``: the CLIP text tower and tokenizer; ``noise``: the base noise;
``merkle``: the commitment)."""
