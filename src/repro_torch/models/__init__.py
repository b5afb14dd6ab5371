"""The LM stack's serving path: layers, GLA, parameters, prefill/decode."""
