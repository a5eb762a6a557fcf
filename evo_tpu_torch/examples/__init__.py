"""Worked examples of the PyTorch port: `hello_evo` (scoring, entropies,
generation, speculative decoding, resumed generation) and `long_context`
(131,072 nt under int8 weights and activations, in segments)."""
