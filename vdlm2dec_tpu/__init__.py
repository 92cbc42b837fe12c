"""vdlm2dec_tpu — a JAX VDL Mode 2 decode framework for accelerators.

Wideband IQ -> batched channelizer -> D8PSK sync/demod -> RS(255,249) FEC ->
HDLC/AVLC -> ACARS/XID, on JAX/XLA with shard_map scaling over (channel,
time) meshes.  Feature-parity target: TLeconte/vdlm2dec (re-designed, not
ported).
"""
__version__ = "0.1.0"
