"""The optimizer: AdamW over the reference's parameter trees."""
