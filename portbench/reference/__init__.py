"""The plain reference: CLIP's towers in float32 (``clip.py``; the modified-ResNet image tower
in ``resnet.py``), its
tokenizer with the byte-level fallback vocabulary (``tokenizer.py``), the
preprocessing of the port's documented JPEG route (``image.py``) and an
exact top-k (``topk.py``). Plain PyTorch, NumPy and Pillow; nothing of
the program, of JAX or of the JAX package is imported here."""
