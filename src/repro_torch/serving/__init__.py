"""Serving: requests, the continuous-batching engine, the pipelined runtime."""
