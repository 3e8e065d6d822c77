"""Serving engine, sampling, OpenAI-style HTTP server."""
