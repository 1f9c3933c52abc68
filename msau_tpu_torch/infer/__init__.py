"""Serve-path modules of the port: decode, schema, reading order, KVModel."""
