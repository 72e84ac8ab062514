"""Chunk + halo combinator."""
