"""Entry points: the static serving driver and its step builders."""
