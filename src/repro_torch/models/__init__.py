"""Model assemblies: layers, attention, KV cache, the decoder and its facade."""
