"""Ingest: the watermarked mutation stream into the live index."""
