"""Neural-network layers (port). This slice carries the attention
helpers the serving path calls; the layer classes come with the
training slice."""
