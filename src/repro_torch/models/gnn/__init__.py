"""Graph neural networks: message passing (``message``), GAT, GIN and
PNA (``models``), the NequIP potential (``nequip``) and the neighbour
sampler (``sampler``).  Every segment sum goes through the segment_sum
kernel on the card."""
