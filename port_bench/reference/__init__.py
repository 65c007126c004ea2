"""The plain reference: NumPy on the collection the benchmark generated.

Nothing here imports the program under test (``repro_torch``), JAX or the
JAX package: the suffix array, the document array and every answer are
worked out again from the generated text.
"""
