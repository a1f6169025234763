"""Topologies, DRT weights, packing, consensus and the decentralized trainer."""
