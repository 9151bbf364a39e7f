"""Entry points: serving and training, and their step builders."""
