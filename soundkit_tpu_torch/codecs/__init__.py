"""Host-side codec pieces the port needs: ADTS framing, the AAC wire
packers and the G.726 code packing (numpy, no torch)."""
