"""Device operations of the packed encode path (front, transport, bit
packing, payload) and the CUDA kernel loader."""
