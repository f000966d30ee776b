"""Secure aggregation: pairwise masks, the secure FedAvg round, Paillier."""
