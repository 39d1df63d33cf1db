"""Neural-network configuration, layers, updaters and
``MultiLayerNetwork`` (port). This slice carries what the causal LM
trains with; see ``layers``, ``config``, ``updaters``, ``weights`` and
``multilayer``."""
