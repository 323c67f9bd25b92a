"""The cim_mbiw kernel: input-serial int8 matmul with the fused DSCI-ADC."""
