"""Checkpoint interop of the PyTorch port: the safetensors file format
(``safetensors_io``) and the HF name tables (``hf_import``)."""
