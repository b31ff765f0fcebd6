"""Caption metrics: BLEU 1-4, METEOR, ROUGE-L, CIDEr(-D) and SPICE behind the
COCO harness (`harness.py`), and the CIDEr-D of the SCST rewards (counterpart
of the JAX package's `evalcap/`)."""
