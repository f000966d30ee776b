"""Federated averaging: server state, local training, aggregators."""
