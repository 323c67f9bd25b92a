"""Macro model: hardware constants, quantizers, ABN, tile mapping."""
